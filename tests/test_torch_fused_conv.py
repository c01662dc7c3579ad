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
