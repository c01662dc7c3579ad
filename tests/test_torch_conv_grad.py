"""The fused conv block's backward against ``jax.vjp`` of the JAX layers.

``FusedConvBlockFn`` (on the CPU: the fused kernel's plain version forward
and ``reference_conv_block_backward``) is held against the gradients JAX
takes through ``MaskedConv1D`` + ``MaskedDYT`` + the residual add and the
activation, on the same numpy-seeded inputs, for the residual block's
forms: conv1 (in_mask, out_mask, bias then DYT, gelu_tanh), conv2 (the
same plus the residual) and bias-only (the masked-BN blocks' conv: bias,
in_mask, no epilogue), and an unmasked conv1, at k 3 / 5 and C 16 / 32.

Tolerance: f32, 1e-5 of each gradient's largest magnitude. The two sides
sum the k * C products and the N * L rows of the weight gradient in
different orders; 1e-5 of the scale is a few hundred f32 ulps at these
sizes.

The backward's kernel-side pieces (the flipped-weight data gradient, the
plans, row partitions and C interfaces of ``conv_wgrad`` and
``conv_epilogue_bwd``) are checked here without a card; the kernels themselves are compared with these plain versions by
``chip_smoke.py`` on the H100.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.models import layers as JL
from jaeger_tpu_torch.ops import fused_conv_grad as fg
from jaeger_tpu_torch.ops.fused_conv import reference_conv_block

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _jax_block(form, k, act, x, in_mask, out_mask, kernel, bias, alpha,
               gamma, beta, residual):
    """The residual block's conv form through the JAX layers."""
    c = x.shape[-1]
    y, _ = JL.MaskedConv1D(filters=c, kernel_size=k, padding="same").apply(
        {"params": {"kernel": kernel, "bias": bias}}, x, in_mask)
    if form == "bias":
        return y
    y, _ = JL.MaskedDYT().apply(
        {"params": {"alpha": alpha, "gamma": gamma, "beta": beta}}, y,
        out_mask)
    if form == "conv2":
        y = y + residual
    return jax.nn.gelu(y, approximate=act == "gelu_tanh")


CASES = [(form, k, c, masked)
         for form in ("conv1", "conv2", "bias")
         for k, c in ((3, 16), (5, 32))
         for masked in (True, False)]


@pytest.mark.parametrize("form,k,c,masked", CASES)
def test_fused_conv_backward_matches_jax_vjp(form, k, c, masked):
    rng = np.random.default_rng(k * 100 + c + masked)
    b, f, length = 2, 3, 37
    act = "gelu_tanh"
    x = rng.normal(size=(b, f, length, c)).astype(np.float32)
    kernel = (rng.normal(size=(k, c, c)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    alpha = np.asarray([0.7], np.float32)
    gamma = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    beta = rng.normal(size=(c,)).astype(np.float32)
    residual = rng.normal(size=(b, f, length, c)).astype(np.float32)
    in_mask = rng.random((b, f, length)) > 0.2 if masked else None
    out_mask = rng.random((b, f, length)) > 0.2 if masked else None
    dy = rng.normal(size=(b, f, length, c)).astype(np.float32)

    def fn(x_, kernel_, bias_, alpha_, gamma_, beta_, residual_):
        return _jax_block(form, k, act, x_, in_mask, out_mask, kernel_,
                          bias_, alpha_, gamma_, beta_, residual_)

    args = (x, kernel, bias, alpha, gamma, beta, residual)
    want_y, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    want = dict(zip(("x", "kernel", "bias", "alpha", "gamma", "beta",
                     "residual"), vjp(jnp.asarray(dy))))

    t = {name: torch.tensor(v, requires_grad=True)
         for name, v in zip(want, args)}
    n = b * f

    def m3(m):
        return None if m is None else torch.from_numpy(m.reshape(n, length))

    dyt = None
    if form != "bias":
        dyt = torch.stack([t["alpha"].expand(c), t["gamma"], t["beta"]])
    y = fg.FusedConvBlockFn.apply(
        t["x"].reshape(n, length, c), t["kernel"], t["bias"], dyt,
        t["residual"].reshape(n, length, c) if form == "conv2" else None,
        m3(in_mask), m3(out_mask) if form != "bias" else None,
        act if form != "bias" else "none", form != "bias")
    np.testing.assert_allclose(
        y.detach().numpy().reshape(dy.shape), np.asarray(want_y),
        rtol=TOL, atol=TOL * float(np.abs(want_y).max()))
    names = [k_ for k_ in want if t[k_] is not None]
    got = torch.autograd.grad(y, [t[k_] for k_ in names],
                              torch.from_numpy(dy.reshape(n, length, c)),
                              allow_unused=True)
    for name, g in zip(names, got):
        w = np.asarray(want[name])
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=f"d{name}")


def test_even_k_refused_before_launch():
    x = torch.zeros(2, 9, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 2, item 7"):
        fg.FusedConvBlockFn.apply(x, torch.zeros(4, 16, 16), None, None,
                                  None, None, None, "none", False)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_flipped_weights_are_the_transposed_conv(k):
    """For odd k the data gradient of a SAME conv is a SAME conv with
    ``W'[j] = W[k - 1 - j]^T``: equal to autograd of the plain conv."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(3, 20, 16, generator=gen, requires_grad=True)
    w = torch.randn(k, 16, 16, generator=gen) * 0.3
    m = torch.rand(3, 20, generator=gen) > 0.3
    du = torch.randn(3, 20, 16, generator=gen)
    want = torch.autograd.grad(reference_conv_block(x, w, in_mask=m), x,
                               du)[0]
    got = reference_conv_block(du, fg.flipped_weights(w), out_mask=m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _c_kinds(src: str, entry: str) -> list:
    """ctypes kinds of a C entry's parameters: pointers and the stream as
    c_void_p, the rest c_int."""
    proto = re.search(rf'extern "C" int {entry}\((.*?)\)', src,
                      re.S).group(1)
    return [ctypes.c_void_p if ("*" in a or "stream" in a) else ctypes.c_int
            for a in proto.split(",")]


def test_wgrad_plan_and_c_interface():
    plan = fg.wgrad_plan(1536, 500, 128, 5, torch.bfloat16, 132)
    # C = 128: two ci blocks of 64 share each tile (one co block of 128), one
    # CTA per SM; 4 stages of a 68-row x halo box and two 64 x 64 du boxes
    assert plan == {"route": "wgmma", "groups": 66, "group": 2, "ctas": 132,
                    "co_block": 128, "stages": 4,
                    "smem": 4 * (9216 + 2 * 8192) + 96 + 1024,
                    "cluster": False}
    assert fg.wgrad_plan(6, 300, 64, 3, torch.bfloat16, 132) == {
        "route": "wgmma", "groups": 30, "group": 1, "ctas": 30,
        "co_block": 64, "stages": 4,
        "smem": 4 * (9216 + 2 * 4096) + 1120, "cluster": False}
    big = fg.wgrad_plan(64, 500, 256, 5, torch.bfloat16, 132)
    assert (big["group"], big["groups"], big["co_block"]) == (8, 16, 128)
    assert big["ctas"] <= 132 and big["smem"] <= 232448
    # one tile: one share, whatever the SM count
    assert fg.wgrad_plan(1, 64, 128, 5, torch.bfloat16, 132)["groups"] == 1
    assert fg.wgrad_plan(6, 300, 32, 5, torch.float32, 132)["route"] == "fma"
    assert fg.wgrad_plan(6, 300, 48, 7, torch.float32, 132)["co_block"] == 0
    for bad in ((6, 30, 24, 5, torch.bfloat16), (6, 30, 64, 4, torch.bfloat16),
                (6, 30, 64, 7, torch.bfloat16), (6, 30, 64, 1, torch.bfloat16),
                (6, 30, 48, 3, torch.bfloat16), (6, 30, 24, 3, torch.float32)):
        with pytest.raises(ValueError):
            fg.wgrad_plan(*bad, 132)
    src = (ROOT / "jaeger_tpu_torch" / "csrc" / "fused_conv_wgrad.cu"
           ).read_text()
    hdr = (ROOT / "jaeger_tpu_torch" / "csrc" / "hopper.cuh").read_text()
    assert _c_kinds(src, "jt_conv_wgrad") == fg.WGRAD_ARGTYPES
    # wgmma with B MN-major (transpose bit), TMA and an mbarrier ring
    assert "wgmma_bf16_rs_mn" in src and "smem_desc_mn" in src
    assert "wgmma.mma_async" in hdr and "cp.async.bulk.tensor" in hdr
    assert "tma_load_3d" in src and "mbar_wait" in src and "mbarrier" in hdr
    assert "atomicAdd" not in src
    assert "__global__ void wgrad_f32" in src
    assert "jaeger_tpu/ops/pallas_conv.py" in src


def test_epilogue_plan_and_c_interface():
    bf16, f32 = torch.bfloat16, torch.float32
    # train shape, conv2 form: 32 rows of 256 B a chunk, 8 KB of each of
    # dy, u, r; two CTAs per SM
    assert fg.epilogue_plan(1536 * 500, 128, bf16, True, 132) == {
        "rows_per_chunk": 32, "chunks": 24000, "ctas": 264, "stages": 4,
        "smem": 4 * 3 * 8192 + 64}
    assert fg.epilogue_plan(1536 * 500, 128, bf16, False, 132)["smem"] == (
        4 * 2 * 8192 + 64)
    # C 16 / 48 / 256 (f32 and bf16): R * row bytes <= 8 KB, R <= 64
    for c, dt, r, smem in ((16, f32, 64, 4 * 2 * 4096 + 64),
                           (48, f32, 32, 4 * 2 * 6144 + 64),
                           (256, f32, 8, 4 * 2 * 8192 + 64),
                           (16, bf16, 64, 4 * 2 * 2048 + 64),
                           (256, bf16, 16, 4 * 2 * 8192 + 64)):
        plan = fg.epilogue_plan(1800, c, dt, False, 132)
        assert plan["rows_per_chunk"] == r and plan["smem"] == smem, (c, dt)
        assert plan["ctas"] == min(264, -(-1800 // r))
    assert fg.epilogue_plan(5, 128, bf16, True, 132)["ctas"] == 1
    for rows, c, dt in ((0, 128, bf16), (100, 24, bf16), (100, 8, f32),
                        (100, 1040, bf16), (100, 1040, f32)):
        with pytest.raises(ValueError):
            fg.epilogue_plan(rows, c, dt, True, 132)
    src = (ROOT / "jaeger_tpu_torch" / "csrc" / "conv_epilogue_bwd.cu"
           ).read_text()
    assert _c_kinds(src, "jt_conv_epilogue_bwd") == fg.EPILOGUE_ARGTYPES
    assert "bulk_load" in src and "mbar_wait" in src
    assert "atomicAdd" not in src
    assert "jaeger_tpu/ops/pallas_conv.py" in src
    py = (ROOT / "jaeger_tpu_torch" / "ops" / "fused_conv_grad.py"
          ).read_text()
    assert "triton" not in py


@pytest.mark.parametrize("length", [1, 63, 65, 500])
def test_plans_cover_every_row_once_in_order(length):
    """Both kernels' partitions of the rows: every (n, l) in exactly one
    share, the shares in order and contiguous, so the partial sums are
    added in one fixed order."""
    n = 7
    rows = n * length
    for groups in (1, 3, 66):
        shares = fg.wgrad_shares(n, length, min(groups, n * -(-length // 64)))
        tiles = [t for sh in shares for t in sh]
        assert tiles == list(range(n * -(-length // 64)))
        covered = [(t // -(-length // 64), (t % -(-length // 64)) * 64 + r)
                   for t in tiles for r in range(64)
                   if (t % -(-length // 64)) * 64 + r < length]
        assert covered == [(i, l) for i in range(n) for l in range(length)]
    for dt, c in ((torch.bfloat16, 128), (torch.float32, 48)):
        for sms in (1, 2, 132):
            plan = fg.epilogue_plan(rows, c, dt, True, sms)
            got = [r for sh in fg.epilogue_shares(rows, plan) for r in sh]
            assert got == list(range(rows))


def test_wrappers_launch_or_raise_on_other_devices():
    """CPU tensors take the plain versions; a device that is neither CPU
    nor CUDA raises instead of falling back."""
    x = torch.zeros(2, 5, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fg.conv_wgrad(x, x, None, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        fg.conv_epilogue_bwd(x, x)
    y = torch.randn(2, 5, 16)
    dw, db = fg.conv_wgrad(y, y, None, 3)
    assert dw.shape == (3, 16, 16) and db.shape == (16,)
