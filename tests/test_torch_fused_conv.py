"""The port's fused conv block (plain PyTorch version) against JAX.

``jaeger_tpu_torch.ops.fused_conv.reference_conv_block`` is the CPU twin
of the Hopper kernel; ``fused_conv_block`` on a CPU tensor takes it. Both
are held against the Pallas kernel (interpret mode) and its XLA reference
on the cases of tests/test_pallas_conv.py, with that file's tolerances:
2e-4 in f32 and 5e-2 in bf16 (bf16 keeps 8 mantissa bits, and the two
sides round at different places). The extensions that carry the model's
residual blocks are held against the JAX layers they replace
(``MaskedConv1D`` + ``MaskedDYT`` + activation + shortcut), with masks;
positions the layers zero must be exactly +0.0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.models import layers as JL
from jaeger_tpu.ops.pallas_conv import fused_conv_block as jax_fused
from jaeger_tpu.ops.pallas_conv import reference_conv_block as jax_reference
from jaeger_tpu_torch.models.layers import MaskedConv1D
from jaeger_tpu_torch.ops import fused_conv


def _data(rng, n, length, c, k):
    x = rng.normal(size=(n, length, c)).astype(np.float32)
    w = rng.normal(size=(k, c, c)).astype(np.float32) * 0.05
    bias = rng.normal(size=(c,)).astype(np.float32)
    dyt = np.stack([
        np.full(c, 0.5, np.float32),
        rng.normal(size=c).astype(np.float32),
        rng.normal(size=c).astype(np.float32),
    ])
    return x, w, bias, dyt


# (n, length, k, act, use_dyt, dtype, tol): the test_pallas_conv.py cases
PALLAS_CASES = {
    "bias_k3": (8, 300, 3, "none", False, "float32", 2e-4),
    "bias_k5": (8, 300, 5, "none", False, "float32", 2e-4),
    "bias_k7": (8, 300, 7, "none", False, "float32", 2e-4),
    "dyt_gelu": (8, 256, 5, "gelu", True, "float32", 2e-4),
    "ragged_relu": (10, 333, 5, "relu", False, "float32", 2e-4),
    "bf16": (8, 256, 5, "none", False, "bfloat16", 5e-2),
}


# past the f32 kernel's 9-tap register window: tap blocks over resident
# weights (C 48 and 128 at k 11; C 48 at k 31) and streamed weights (C 128
# at k 31)
WIDE_TAP_CASES = [(48, 11), (48, 31), (128, 11), (128, 31)]


@pytest.mark.parametrize("c,k", WIDE_TAP_CASES)
def test_twin_matches_pallas_kernel_past_nine_taps(rng, c, k):
    """f32, DYT + gelu: the twin against the Pallas kernel in interpret
    mode and its XLA reference, to 1e-5 of the output's scale (the sums
    of k * C products in another order)."""
    x, w, bias, dyt = _data(rng, 3, 70, c, k)
    pallas = jax_fused(jnp.asarray(x), jnp.asarray(w), dyt=jnp.asarray(dyt),
                       act="gelu", use_dyt=True, interpret=True, tile_n=2,
                       tile_l=32)
    xla = jax_reference(jnp.asarray(x), jnp.asarray(w), dyt=jnp.asarray(dyt),
                        act="gelu", use_dyt=True)
    got = fused_conv.fused_conv_block(
        torch.from_numpy(x), torch.from_numpy(w), dyt=torch.from_numpy(dyt),
        act="gelu", use_dyt=True).numpy()
    for ref in (pallas, xla):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_twin_matches_pallas_kernel(rng, case):
    n, length, k, act, use_dyt, dt, tol = PALLAS_CASES[case]
    x, w, bias, dyt = _data(rng, n, length, 128, k)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    kw = dict(dyt=jnp.asarray(dyt), use_dyt=True) if use_dyt else dict(
        bias=jnp.asarray(bias))
    jx = jnp.asarray(x).astype(jdt)
    pallas = jax_fused(jx, jnp.asarray(w), act=act, interpret=True,
                       tile_n=8, tile_l=128, **kw)
    xla = jax_reference(jx, jnp.asarray(w), act=act, **kw)
    tkw = dict(dyt=torch.from_numpy(dyt), use_dyt=True) if use_dyt else dict(
        bias=torch.from_numpy(bias))
    tx = torch.from_numpy(x).to(tdt)
    out = fused_conv.fused_conv_block(tx, torch.from_numpy(w), act=act, **tkw)
    twin = fused_conv.reference_conv_block(tx, torch.from_numpy(w), act=act,
                                           **tkw)
    assert out.dtype == tdt
    assert torch.equal(out, twin)          # CPU tensors take the twin
    got = out.float().numpy()
    for ref in (pallas, xla):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


def test_dyt_mode_ignores_bias(rng):
    """Pallas semantics: in DYT mode the bias is not added."""
    x, w, bias, dyt = _data(rng, 2, 40, 16, 3)
    args = (torch.from_numpy(x), torch.from_numpy(w))
    with_bias = fused_conv.reference_conv_block(
        *args, bias=torch.from_numpy(bias), dyt=torch.from_numpy(dyt),
        use_dyt=True)
    without = fused_conv.reference_conv_block(
        *args, dyt=torch.from_numpy(dyt), use_dyt=True)
    assert torch.equal(with_bias, without)


def _jax_block(x, w, bias, dyt, mask, act, shortcut, dtype):
    """MaskedConv1D (SAME) -> MaskedDYT (re-zero) -> act(. + shortcut)."""
    n, length, c = x.shape
    k = w.shape[0]
    conv = JL.MaskedConv1D(filters=c, kernel_size=k, padding="same",
                           dtype=dtype)
    y, m = conv.apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}},
        jnp.asarray(x).astype(dtype)[:, None],
        None if mask is None else jnp.asarray(mask)[:, None])
    y, _ = JL.MaskedDYT(dtype=dtype).apply(
        {"params": {"alpha": jnp.asarray(dyt[0, :1]),
                    "gamma": jnp.asarray(dyt[1]),
                    "beta": jnp.asarray(dyt[2])}}, y, m)
    if shortcut is not None:
        y = y + jnp.asarray(shortcut).astype(dtype)[:, None]
    y = JL.get_activation(act)(y)
    return np.asarray(y[:, 0], np.float32), (
        None if m is None else np.asarray(m[:, 0]))


EXT_CASES = ["bias_then_dyt", "in_mask", "in_out_mask", "residual", "all"]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EXT_CASES)
def test_extensions_match_jax_layers(rng, case, dt):
    n, length, c, k = 4, 70, 16, 5
    x, w, bias, dyt = _data(rng, n, length, c, k)
    dyt[0] = 0.7                             # the layer's scalar alpha
    mask = None
    if case in ("in_mask", "in_out_mask", "all"):
        mask = rng.random((n, length)) > 0.3
        mask[0, :20] = False                 # a run the conv cannot bridge
        mask[1, -9:] = False                 # trailing padding
    shortcut = (rng.normal(size=(n, length, c)).astype(np.float32)
                if case in ("residual", "all") else None)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    ref, m_out = _jax_block(x, w, bias, dyt, mask, "gelu", shortcut, jdt)

    t_mask = None if mask is None else torch.from_numpy(mask)
    out_mask = None
    if case in ("in_out_mask", "all"):
        conv = MaskedConv1D(c, c, k, padding="same")
        out_mask = conv.output_mask(t_mask[:, None])[:, 0]
        np.testing.assert_array_equal(out_mask.numpy(), m_out)
    got = fused_conv.fused_conv_block(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w),
        torch.from_numpy(bias).to(tdt).float(),
        torch.from_numpy(dyt).to(tdt).float(),
        act="gelu_tanh" if dt == "bfloat16" else "gelu", use_dyt=True,
        bias_then_dyt=True, in_mask=t_mask, out_mask=out_mask,
        residual=(None if shortcut is None
                  else torch.from_numpy(shortcut).to(tdt)))
    got = got.float().numpy()
    tol = 5e-2 if dt == "bfloat16" else 2e-4
    if out_mask is not None and shortcut is None:
        # the re-zeroed positions are exactly +0.0 on both sides
        zero = ~m_out
        assert zero.any()
        assert np.all(got[zero] == 0) and not np.signbit(got[zero]).any()
        assert np.all(ref[zero] == 0)
    if out_mask is None and mask is not None:
        # without the re-zero, masked inputs still read as zero: compare
        # only where JAX's layer keeps the value (valid outputs)
        got, ref = got[m_out], ref[m_out]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_cpu_wrapper_rejects_bad_flags(rng):
    x, w, bias, dyt = _data(rng, 1, 8, 16, 3)
    with pytest.raises(ValueError):
        fused_conv.fused_conv_block(torch.from_numpy(x), torch.from_numpy(w),
                                    bias=torch.from_numpy(bias),
                                    bias_then_dyt=True)
    with pytest.raises(ValueError):
        fused_conv.fused_conv_block(torch.from_numpy(x), torch.from_numpy(w),
                                    act="swish")


def test_cpu_path_counts_no_launch(rng):
    x, w, bias, _ = _data(rng, 1, 8, 16, 3)
    before = fused_conv.launches
    fused_conv.fused_conv_block(torch.from_numpy(x), torch.from_numpy(w),
                                bias=torch.from_numpy(bias))
    assert fused_conv.launches == before


def _csrc():
    from pathlib import Path

    return Path(fused_conv.__file__).resolve().parent.parent / "csrc"


def test_kernel_source_declares_its_interface():
    """The CUDA source is only compiled on the card; pin the C entry
    point, the arguments the ctypes binding passes, and the Hopper
    instructions the bf16 path is built from."""
    src = (_csrc() / "fused_conv_block.cu").read_text()
    hopper = (_csrc() / "hopper.cuh").read_text()
    assert 'extern "C" int jt_fused_conv_block(' in src
    sig = src[src.index("jt_fused_conv_block("):]
    sig = sig[: sig.index(")")]
    assert sig.count(",") + 1 == len(fused_conv.ARGTYPES) == 20
    assert "jaeger_tpu/ops/pallas_conv.py" in src
    assert '#include "hopper.cuh"' in src
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
                  "ldmatrix", "setmaxnreg"):
        assert instr in hopper, instr
    assert "nvcuda::wmma" not in src and "mma.h" not in src


# (C, k) of the repo's residual convs: demo, train_config (axial,
# crossframe), the flagship, the variable-length config's k7 and a C 256
REPO_SHAPES = [(32, 3), (64, 3), (128, 5), (128, 7), (256, 5)]


@pytest.mark.parametrize("c,k", REPO_SHAPES)
def test_launch_plan_fits(c, k):
    plan = fused_conv.conv_plan(c, k)
    assert c % plan["cb"] == 0 and plan["cb"] % 16 == 0
    assert c % plan["kw"] == 0 and plan["kw"] in (16, 32, 64)
    assert 2 <= plan["stages"] <= 4
    assert plan["smem"] <= 232448
    assert plan["smem"] == fused_conv.plan_bytes(c, k, plan["cb"],
                                                 plan["kw"], plan["stages"])
    # the resident weights of one column block are part of the budget
    assert plan["smem"] > k * c * plan["cb"] * 2
    f32 = fused_conv.conv_plan(c, k, torch.float32)
    assert f32["smem"] <= 232448


def test_launch_plan_flagship_keeps_all_weights():
    assert fused_conv.conv_plan(128, 5) == dict(cb=128, kw=64, stages=3,
                                                smem=222256)


@pytest.mark.parametrize("c,k,dtype", [
    (1024, 5, torch.bfloat16),     # k * C * 16 weights + two x stages
    (24, 3, torch.bfloat16),       # C % 16
    (128, 57, torch.bfloat16),     # in_mask bits / TMA box rows
    (512, 5, torch.float32),       # f32 tile + weight tap
    (144, 3, torch.float32),       # f32: C <= 128 or C % 128 == 0
])
def test_launch_plan_refuses_what_cannot_fit(c, k, dtype):
    with pytest.raises(ValueError):
        fused_conv.conv_plan(c, k, dtype)


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh must not load a library built from the old
    header."""
    from jaeger_tpu_torch.ops import cuda_build

    for f in ("fused_conv_block.cu", "hopper.cuh"):
        (tmp_path / f).write_bytes((_csrc() / f).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    flags = cuda_build.NVCC_FLAGS
    before = cuda_build._digest("fused_conv_block", flags)
    assert before == cuda_build._digest("fused_conv_block", flags)
    (tmp_path / "hopper.cuh").write_bytes(
        (tmp_path / "hopper.cuh").read_bytes() + b"\n// edited\n")
    assert cuda_build._digest("fused_conv_block", flags) != before
    assert cuda_build._digest("fused_conv_block", flags + ("-G",)) != \
        cuda_build._digest("fused_conv_block", flags)


# the f32 plan: route f32_ring (the persistent FMA kernel) with the
# largest column block of 64, 32, 16 whose resident weights (all k taps)
# and >= 2 ring stages fit, the most stages (<= 4) beside them; (route,
# cb, stages)
F32_REPO_PLANS = {
    (32, 3): ("f32_ring", 32, 4),
    (64, 3): ("f32_ring", 64, 4),
    (128, 5): ("f32_ring", 64, 3),
    (128, 7): ("f32_ring", 32, 4),
    (256, 5): ("f32_ring", 32, 3),
}


@pytest.mark.parametrize("c,k", REPO_SHAPES)
def test_f32_plan_route_block_and_bytes(c, k):
    plan = fused_conv.conv_plan(c, k, torch.float32)
    route, cb, stages = F32_REPO_PLANS[(c, k)]
    # the weights, 4 x cb parameters, and 8 warps' rings: stages of a warp
    # unit's 32 + k - 1 rows x 16 f32
    smem = 4 * k * c * cb + 16 * cb + 8 * stages * (32 + k - 1) * 64
    assert plan == dict(route=route, cb=cb, kw=0, tile=32, taps=k,
                        stages=stages, smem=smem)
    assert smem <= fused_conv.SMEM_LIMIT
    assert smem == fused_conv.f32_plan_bytes(c, k, cb, stages)
    # one more stage would not fit
    if stages < 4:
        assert fused_conv.f32_plan_bytes(c, k, cb, stages + 1) > 232448
    # the flagship keeps a 64-column block of all five taps resident
    # (163,840 B) beside 8 warps' rings of three 36-row x 16-channel stages
    if (c, k) == (128, 5):
        assert smem == 220160
    # up to 9 taps the whole window is one tap block
    assert fused_conv.f32_tap_blocks(k, plan["taps"]) == (1, k)


def _f32_rule(c: int, k: int) -> bool:
    """The set of (C, k) the f32 kernel took before the ring route: C %
    16 == 0, C <= 128 or C % 128 == 0, a 64 + k - 1 row tile of C f32 and
    one weight tap of C x min(C, 128) f32 within 232,448 B."""
    return (c % 16 == 0 and (c <= 128 or c % 128 == 0)
            and ((64 + k - 1) * c + c * min(c, 128)) * 4 <= 232448)


def _f32_max_taps(c: int) -> int:
    """The most taps ``_f32_rule`` takes at C channels (0: none)."""
    if c % 16 or (c > 128 and c % 128):
        return 0
    return max(0, 232448 // 4 // c - min(c, 128) - 63)


@pytest.mark.parametrize("c", range(16, 513, 16))
def test_f32_plan_takes_the_same_shapes(c):
    """Every (C, k) of the rule, k up to its limit, goes to route
    f32_ring: all k taps resident (tap blocks of at most 9) where they fit
    at a column block of 64 or 32, else streamed in blocks of ``taps`` < k
    with two weight buffers and two ring stages (at a column block of 64
    or 32 where C % 32 == 0), else resident at 16, else streamed at 16;
    the layout's bytes fit. Past the limit, ValueError."""
    top = _f32_max_taps(c)
    for k in range(1, top + 3):
        if not _f32_rule(c, k):
            assert k > top
            with pytest.raises(ValueError):
                fused_conv.conv_plan(c, k, torch.float32)
            continue
        plan = fused_conv.conv_plan(c, k, torch.float32)
        assert plan["route"] == "f32_ring", (c, k, plan)
        assert c % plan["cb"] == 0 and plan["cb"] in (16, 32, 64)
        taps, stages = plan["taps"], plan["stages"]
        blocks, block = fused_conv.f32_tap_blocks(k, taps)
        rows = 32 + block - 1
        if taps == k:
            assert block <= 9 and block * blocks >= k > (block - 1) * blocks
            weights = 4 * k * c * plan["cb"]
        else:
            assert stages == 2 and 1 <= taps <= 9 and block == taps
            weights = 2 * 4 * taps * c * plan["cb"]
            # resident would not fit at a column block this wide or wider
            for cb in (64, 32, 16):
                if c % cb == 0 and cb >= min(plan["cb"], 32):
                    assert fused_conv.f32_plan_bytes(c, k, cb, 2) > 232448
            assert (plan["cb"] >= 32) == (c % 32 == 0)
        assert plan["smem"] == (weights + 16 * plan["cb"]
                                + 8 * stages * rows * 64) <= 232448
        assert plan["smem"] == fused_conv.f32_plan_bytes(
            c, k, plan["cb"], stages, taps)


def test_f32_kernel_source_declares_its_interface():
    """The f32 ring kernel, its layout's constants (as the wrapper's plan
    computes them) and the C entry's f32 routes."""
    import re

    src = (_csrc() / "fused_conv_block.cu").read_text()
    hopper = (_csrc() / "hopper.cuh").read_text()
    assert "__global__ void __launch_bounds__(R_THREADS, 1)\nconv_f32_ring(" \
        in src
    # one f32 kernel and route: the first f32 kernel is gone
    assert "conv_f32_fma" not in src and "staged_bytes" not in src
    assert "f32_staged" not in src
    consts = dict(re.findall(r"constexpr int (R_\w+) = (\d+);", src))
    # a warp's unit: 4 row groups of R_RT rows
    assert 4 * int(consts["R_RT"]) == fused_conv.F32_TILE
    assert int(consts["R_CK"]) == fused_conv.F32_CHUNK
    assert int(consts["R_KMAX"]) == fused_conv.F32_MAX_TAPS
    assert int(consts["R_WARPS"]) == fused_conv.F32_WARPS == 8
    assert "make_ring_layout(n_rows, L, C, K, cb, kw, stages, &lay)" in src
    assert "lay.bytes != (uint32_t)smem_bytes" in src
    # tap blocks, resident or streamed through two weight buffers
    assert "ring_products<9, CT>(acc, xs, wc, C * CB, CB, tr)" in src
    assert "lay->off_par = (stream ? 2u : 1u) * lay->wbuf;" in src
    for cb in fused_conv._F32_CBS:
        assert f"launch_f32_ring<{cb}>" in src
    # x tiles by cp.async with zero fill, never TF32 (no tensor-core f32)
    assert "cp_async16_zfill" in src and "cp.async.cg.shared.global" in hopper
    assert ".tf32" not in src and "float_to_tf32" not in src
    assert "fmaf(" in src
    assert isinstance(fused_conv.route_launches, __import__(
        "collections").Counter)
