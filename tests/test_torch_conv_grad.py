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
plan and the C interface of ``conv_wgrad``) are checked here without a
card; the kernels themselves are compared with these plain versions by
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
    with pytest.raises(NotImplementedError, match="item 11"):
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


def test_wgrad_plan_and_c_interface():
    plan = fg.wgrad_plan(1536, 500, 128, 5, torch.bfloat16, 132)
    assert plan == {"cb": 64, "splits": 66}
    assert fg.wgrad_plan(6, 300, 64, 3, torch.bfloat16, 132) == {
        "cb": 64, "splits": 30}
    assert fg.wgrad_plan(6, 300, 32, 5, torch.float32, 132)["cb"] == 0
    assert fg.wgrad_plan(6, 300, 48, 7, torch.float32, 132)["cb"] == 0
    for bad in ((6, 30, 24, 5, torch.bfloat16), (6, 30, 64, 4, torch.bfloat16),
                (6, 30, 64, 7, torch.bfloat16), (6, 30, 64, 1, torch.bfloat16),
                (6, 30, 48, 3, torch.bfloat16), (6, 30, 24, 3, torch.float32)):
        with pytest.raises(ValueError):
            fg.wgrad_plan(*bad, 132)
    src = (ROOT / "jaeger_tpu_torch" / "csrc" / "fused_conv_wgrad.cu"
           ).read_text()
    proto = re.search(r'extern "C" int jt_conv_wgrad\((.*?)\)', src,
                      re.S).group(1)
    kinds = [ctypes.c_void_p if ("*" in a or "stream" in a) else ctypes.c_int
             for a in proto.split(",")]
    assert kinds == fg.WGRAD_ARGTYPES
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in src
    assert "cp.async.cg.shared.global" in src
    assert "atomicAdd" not in src
    assert "jaeger_tpu/ops/pallas_conv.py" in src


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
