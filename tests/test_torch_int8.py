"""The port's int8 path against the Pallas int8 kernel and the JAX package.

* (a) The requant plain version equals the Pallas kernel
  ``experiments/pallas_int8_conv.py::int8_conv_layer`` in interpret mode
  and its ``xla_reference`` bit for bit at the kernel's block shape: the
  integer sums are exact and both sides round half to even.
* (b) Both plain versions against ``jax.lax.conv_general_dilated`` in
  int8 with int32 accumulation (SAME / VALID, dilation 1 / 3, C_in !=
  C_out, and the ragged route's channel counts: C_in 4 / C_out 20, k 10,
  VALID; C_in 24 / C_out 40, SAME, dilation 3), again exactly: the
  dequantize is the same f32 operations. The launch plan of each route,
  the ragged route's included (C_in or C_out not a multiple of 16, which
  the wrapper once refused).
* (c) ``MaskedConv1D`` and ``ResidualBlock`` (DYT and masked BN) with
  quant buffers against the JAX layers with a ``quant`` collection. f32:
  1e-5 of each output's scale (the integer products are exact and the
  dequantize runs the same f32 operations; only the float ops around them
  sum or round in another order). bf16: PR 1's 5e-2 of scale (the JAX
  layer rounds to bf16 after the dequantize and after every epilogue op,
  the port once).
* (d) Whole models: a JAX ``full_int8`` bundle of tests/test_int8_exec.py's
  ``CFG`` and of a narrow DYT residual model, loaded by the port's
  ``load_model``, against JAX's ``load_quantized`` apply in the dense,
  bounded and masked programs. bf16: 5e-2 of scale. f32: the median
  element within 1e-5 of scale and every element within 1e-2. Across a
  whole model an upstream f32 sum that differs in its last bit can move a
  value across a rounding boundary, which changes one int8 step of one
  input of the next int8 conv. One such step moves the outputs of that
  window by up to act_scale * w_scale * 127, about 1 % of the conv's output
  scale (4e-3 of scale measured on a pooled value of the DYT model). Which
  values flip depends on both sides' f32 summation order (XLA's differs
  with its device count); away from a flip the outputs agree to f32
  rounding. Calls are equal wherever the top two logits are further apart
  than the tolerance.
* (e) The port's ``quantize_bundle`` against JAX's: ``dynamic`` bundles
  equal; in ``full_int8`` the ``kernel_q`` and ``w_scale`` equal and each
  ``act_scale`` within 1 % relative, because the bf16 calibration
  forwards round at other places on the two sides.
* (f) Engine routing under ``--int8 auto``, and a split-mixed batch whose
  clean rows take the int8 model.
* (g) ``run_core`` with the demo bundle's JAX-made ``full_int8`` bundle,
  f32 on the CPU, ``--int8`` and ``--int8 auto``: the TSV byte-identical
  to JAX ``run_core``'s.
* (h) A process without JAX and without ``ml_dtypes`` loads a JAX-written
  ``float16`` bundle (bfloat16 leaves) and a ``full_int8`` bundle.
"""

import copy
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.commands.predict import run_core as jax_run_core
from jaeger_tpu.models import layers as JL
from jaeger_tpu.models.artifacts import save_model as jax_save_model
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.models.conversion import _build_quant_tree
from jaeger_tpu.models.conversion import load_quantized as jax_load_quantized
from jaeger_tpu.models.conversion import quantize_bundle as jax_quantize
from jaeger_tpu_torch.commands.predict import run_core
from jaeger_tpu_torch.infer.engine import InferenceEngine
from jaeger_tpu_torch.models import layers as TL
from jaeger_tpu_torch.models.artifacts import (load_model, load_state,
                                               params_from_jax,
                                               read_flax_msgpack)
from jaeger_tpu_torch.models.builder import mask_cut_plan
from jaeger_tpu_torch.models.conversion import (int8_conv_count,
                                                quantize_bundle)
from jaeger_tpu_torch.ops import int8_conv

ROOT = Path(__file__).resolve().parents[1]
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
DEMO = ROOT / "jaeger_tpu" / "data" / "models" / "demo"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-2, "bfloat16": 5e-2}


def _load_file(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: tests/test_int8_exec.py's three-conv model (dilation 3, C_in != C_out)
CFG = _load_file("_int8_exec_cfg", ROOT / "tests" / "test_int8_exec.py").CFG

#: a narrow flagship: DYT + NMD, two k5 DYT residual blocks of 32 channels
DYT_CFG = {
    "model": {
        "name": "dyt_int8",
        "seed": 0,
        "classifier_out_dim": 3,
        "class_label_map": [{"class": c, "label": i} for i, c in
                            enumerate(["chromosome", "phage", "plasmid"])],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 16},
        "string_processor": {"crop_size": 62, "seq_onehot": False},
        "representation_learner": {
            "hidden_layers": [
                {"name": "masked_conv1d",
                 "config": {"filters": 32, "kernel_size": 7}},
                {"name": "masked_dyt", "config": {}},
                {"name": "nmd", "config": {}},
                {"name": "residual_block",
                 "config": {"block_size": 2, "filters": 32,
                            "kernel_size": 5, "norm_type": "masked_dyt"}},
                {"name": "masked_dyt", "config": {}},
                {"name": "nmd", "config": {}},
            ],
            "pooling": "max",
        },
        "reliability_model": {
            "mode": "nmd", "merge": {"mode": "concat"},
            "hidden_layers": [{"name": "dense",
                               "config": {"units": 1, "dtype": "float32"}}],
        },
        "classifier": {
            "hidden_layers": [{"name": "dense",
                               "config": {"units": 3, "dtype": "float32"}}],
        },
    },
    "training": {},
}


def _randomize(variables, seed=0):
    """Random values for every non-kernel leaf (norms, biases, moving
    statistics), so that each of them shapes the outputs."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name in ("kernel", "embedding"):
            return x
        if name in ("gamma", "moving_variance"):
            return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
        if name == "alpha":
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _assert_close(got: np.ndarray, want: np.ndarray, tol: float, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


# --- (a) the Pallas kernel ---------------------------------------------------

def test_requant_equals_pallas_kernel():
    pk = _load_file("_pallas_int8_conv",
                    ROOT / "experiments" / "pallas_int8_conv.py")
    rng = np.random.default_rng(0)
    x = rng.integers(-40, 40, (pk.ROWS, pk.L, pk.C)).astype(np.int8)
    w = rng.integers(-8, 8, (pk.K, pk.C, pk.C)).astype(np.int8)
    scale = np.full((1, 1), 1.0 / 64.0, np.float32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale))
    pallas = np.asarray(pk.int8_conv_layer(*args, interpret=True))
    xla = np.asarray(pk.xla_reference(*args))
    targs = (torch.from_numpy(x), torch.from_numpy(w),
             torch.from_numpy(scale))
    got = int8_conv.int8_conv_requant(*targs, dilation=pk.DIL)
    plain = int8_conv.reference_int8_conv_requant(*targs, dilation=pk.DIL)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, plain)           # CPU tensors take the plain one
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    assert len(np.unique(pallas)) > 100      # not a saturated output


# --- (b) lax.conv_general_dilated --------------------------------------------

def _lax_int8_conv(q, w, padding, dilation):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(q, jnp.int8), jnp.asarray(w), (1,), padding,
        rhs_dilation=(dilation,), dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dilation", [1, 3])
def test_plain_versions_match_lax_conv(padding, dilation):
    rng = np.random.default_rng(10 + dilation)
    n, length, c_in, c_out, k = 3, 50, 16, 48, 5
    x = rng.normal(size=(n, length, c_in)).astype(np.float32)
    mask = rng.random((n, length)) > 0.2
    wq = rng.integers(-127, 128, (k, c_in, c_out)).astype(np.int8)
    act_scale = np.float32(np.abs(x).max() / 127.0)
    w_scale = (rng.random(c_out) * 1e-2 + 1e-3).astype(np.float32)
    bias = rng.normal(size=c_out).astype(np.float32)

    # layers.py:248-262 step by step
    inv = (1.0 / jnp.float32(act_scale)).astype(jnp.float32)
    xq = jnp.clip(jnp.round(jnp.where(mask[..., None], x, 0.0) * inv),
                  -127.0, 127.0)
    acc = _lax_int8_conv(xq, wq, padding, dilation)
    want = acc.astype(np.float32) * (w_scale * act_scale) + bias

    t_act = torch.tensor(act_scale)
    got = int8_conv.int8_conv_dequant(
        torch.from_numpy(x), torch.from_numpy(wq), 1.0 / t_act,
        torch.from_numpy(w_scale) * t_act, torch.from_numpy(bias),
        dilation=dilation, padding=padding, in_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

    if padding == "SAME":                   # the requant form is SAME only
        xi = rng.integers(-60, 60, (n, length, c_in)).astype(np.int8)
        acc = _lax_int8_conv(xi, wq, padding, dilation)
        want = np.clip(np.round(acc.astype(np.float32) * np.float32(1 / 64)),
                       -127, 127).astype(np.int8)
        got = int8_conv.reference_int8_conv_requant(
            torch.from_numpy(xi), torch.from_numpy(wq), 1.0 / 64,
            dilation=dilation)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c_in,c_out,k,padding,dilation", [
    (4, 20, 10, "VALID", 1),                # the dvf conv's channels, narrow
    (24, 40, 3, "SAME", 3),
])
def test_plain_versions_match_lax_conv_ragged(c_in, c_out, k, padding,
                                              dilation):
    """The ragged route's channel counts: the plain versions the CPU runs
    against the lax conv, exactly (both forms)."""
    rng = np.random.default_rng(c_in)
    n, length = 3, 60
    x = rng.normal(size=(n, length, c_in)).astype(np.float32)
    mask = rng.random((n, length)) > 0.2
    wq = rng.integers(-127, 128, (k, c_in, c_out)).astype(np.int8)
    act_scale = np.float32(np.abs(x).max() / 127.0)
    w_scale = (rng.random(c_out) * 1e-2 + 1e-3).astype(np.float32)
    bias = rng.normal(size=c_out).astype(np.float32)
    inv = (1.0 / jnp.float32(act_scale)).astype(jnp.float32)
    xq = jnp.clip(jnp.round(jnp.where(mask[..., None], x, 0.0) * inv),
                  -127.0, 127.0)
    acc = _lax_int8_conv(xq, wq, padding, dilation)
    want = acc.astype(np.float32) * (w_scale * act_scale) + bias
    t_act = torch.tensor(act_scale)
    got = int8_conv.int8_conv_dequant(
        torch.from_numpy(x), torch.from_numpy(wq), 1.0 / t_act,
        torch.from_numpy(w_scale) * t_act, torch.from_numpy(bias),
        dilation=dilation, padding=padding, in_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)

    xi = rng.integers(-60, 60, (n, length, c_in)).astype(np.int8)
    acc = _lax_int8_conv(xi, wq, "SAME", dilation)
    want = np.clip(np.round(acc.astype(np.float32) * np.float32(1 / 64)),
                   -127, 127).astype(np.int8)
    got = int8_conv.int8_conv_requant(torch.from_numpy(xi),
                                      torch.from_numpy(wq), 1.0 / 64,
                                      dilation=dilation)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_unaligned_channels():
    """The wrapper once refused C_in or C_out not a multiple of 16; it now
    takes them on the ``"ragged"`` route: its checks refuse such a CPU
    tensor only for its device (a CUDA tensor would launch), and on the CPU
    it computes the plain version, equal to the lax conv."""
    x = torch.zeros(1, 8, 24)
    w = torch.zeros(3, 24, 40, dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv._check_conv("int8_conv_dequant", x, w, (torch.float32,),
                              1, "same")
    assert int8_conv.int8_plan(24, 40, 3)["route"] == "ragged"
    rng = np.random.default_rng(5)
    xi = rng.integers(-60, 60, (2, 30, 24)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 24, 40)).astype(np.int8)
    got = int8_conv.int8_conv_requant(torch.from_numpy(xi),
                                      torch.from_numpy(wq), 1.0 / 64)
    want = np.clip(np.round(_lax_int8_conv(xi, wq, "SAME", 1).astype(
        np.float32) * np.float32(1 / 64)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_source_declares_its_interface():
    """The CUDA source is only compiled on the card; pin the C entry
    point, the arguments the ctypes binding passes and the Hopper
    instructions both routes are built from."""
    csrc = ROOT / "jaeger_tpu_torch" / "csrc"
    src = (csrc / "int8_conv.cu").read_text()
    hopper = (csrc / "hopper.cuh").read_text()
    assert 'extern "C" int jt_int8_conv(' in src
    sig = src[src.index("jt_int8_conv("):]
    sig = sig[: sig.index(")")]
    # 1 + 10 pointers + 16 ints (the stride among them) + stream
    assert sig.count(",") + 1 == len(int8_conv.ARGTYPES) == 28
    assert '#include "hopper.cuh"' in src
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in hopper
    for instr in ("wgmma_s8_rs", "tma_load_3d", "tma_store_3d",
                  "encode_s8_3d", "mbar_wait", "ldmatrix_x4",
                  "named_bar_sync"):
        assert instr in src, instr
    assert "cp.async.bulk.tensor" in hopper
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "experiments/pallas_int8_conv.py" in src
    # route 2, the ragged route, re-plans what int8_plan planned: the
    # resident kernel where its layout fits, else the staged one
    for name in ("int8_ragged", "int8_ragged_staged", "ragged_cb",
                 "ragged_resident", "resident_layout", "ragged_pitch",
                 "ragged_taps", "ragged_layout", "route == 2"):
        assert name in src, name
    for instr in ("cp_async16", "cp_async_wait", "__stcs"):
        assert instr in src, instr
    assert "cp.async.cg.shared.global" in hopper


def test_probe_build_is_its_own_library(monkeypatch, tmp_path):
    """``chip_smoke.py --ragged`` loads ``csrc/int8_conv.cu`` built with
    ``-DJT_RAGGED_CYCLES`` beside the plain build: the ``-D`` flag keys it
    apart, so it is built (here: nvcc is missing, so the build raises)
    instead of returning the plain library; phase 2's ``-Xptxas -v`` build
    is the plain library."""
    from jaeger_tpu_torch.ops import cuda_build

    plain = object()
    monkeypatch.setattr(cuda_build, "_LIBS", {"int8_conv": plain})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert cuda_build.load("int8_conv") is plain
    assert cuda_build.load("int8_conv", ("-Xptxas", "-v")) is plain

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("int8_conv", ("-DJT_RAGGED_CYCLES",))
    assert cuda_build._key("int8_conv", ("-Xptxas", "-v",
                                         "-DJT_RAGGED_CYCLES")) == \
        "int8_conv -DJT_RAGGED_CYCLES"
    src = (ROOT / "jaeger_tpu_torch" / "csrc" / "int8_conv.cu").read_text()
    assert 'extern "C" int jt_int8_ragged_cycles(' in src
    assert "#ifdef JT_RAGGED_CYCLES" in src


def test_ptxas_summary_tells_the_ragged_kernels_apart():
    """Phase 2 prints ptxas' registers and spills of each ``int8_ragged``
    instance and, apart, of each ``int8_ragged_staged`` one, by the mangled
    name's length-prefixed identifier."""
    import runpy

    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="smoke")
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111int8_"
        "raggedI13__nv_bfloat16Li128ELi2EEEvNS_6ParamsENS_14ResidentLayoutE"
        "ii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118int8_"
        "ragged_stagedIaLi16ELi4EEEvNS_6ParamsENS_12RaggedLayoutEii' for "
        "'sm_90a'\n"
        "ptxas info    : Used 64 registers\n")
    assert smoke["ptxas_summary"](log, "int8_ragged") == [
        "int8_ragged<bf16, 128, 2>: 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "int8_ragged<bf16, 128, 2>: Used 128 registers"]
    assert smoke["ptxas_summary"](log, "int8_ragged_staged") == [
        "int8_ragged_staged<int8, 16, 4>: Used 64 registers"]


def test_fp32_pipe_rounding_matches_rint():
    """The wgmma route quantizes on the FP32 pipe
    (``csrc/int8_conv.cu::quant8x4``): clip ``x * inv_act`` to [-127, 127],
    add 1.5 * 2**23 (whose own rounding is half to even) and keep the low
    byte. The same float32 steps give the plain version's int8 values,
    halves, out-of-range values and infinities included, and -127 for NaN,
    as ``clip127(__float2int_rn(NaN))`` on the mma route."""
    rng = np.random.default_rng(7)
    v = np.concatenate([rng.normal(scale=90.0, size=200_000),
                        np.arange(-130.0, 130.5, 0.5),
                        [np.inf, -np.inf, 1e30, -1e30, -0.0]]).astype(np.float32)
    for inv in (np.float32(1.0), np.float32(1.0 / 0.37)):
        y = np.fmin(np.fmax(v * inv, np.float32(-127)), np.float32(127))
        got = ((y + np.float32(12582912.0)).view(np.int32) & 0xFF).astype(
            np.uint8).view(np.int8)
        want = int8_conv.quantize_activation(torch.from_numpy(v),
                                             float(inv)).to(torch.int8)
        np.testing.assert_array_equal(got, want.numpy())
    nan = np.fmin(np.fmax(np.float32(np.nan), np.float32(-127)),
                  np.float32(127))
    assert (np.float32(nan + np.float32(12582912.0)).view(np.int32)
            & 0xFF) == 0x81                  # -127


# (c_in, c_out, k, dilation, padding, dtype, route): the flagship, the demo,
# the Pallas shape, C 256, VALID with C_in != C_out, C_in 16, f32
PLAN_SHAPES = [
    (128, 128, 5, 1, "same", torch.bfloat16, "wgmma"),
    (32, 32, 3, 1, "same", torch.bfloat16, "wgmma"),
    (128, 128, 5, 3, "same", torch.int8, "wgmma"),
    (256, 256, 5, 1, "same", torch.bfloat16, "wgmma"),
    (256, 256, 5, 1, "same", torch.int8, "wgmma"),
    (32, 48, 5, 3, "valid", torch.bfloat16, "wgmma"),
    (16, 32, 3, 3, "same", torch.float32, "mma"),
    (16, 32, 3, 3, "same", torch.bfloat16, "mma"),
    (128, 128, 5, 1, "same", torch.float32, "mma"),
]


@pytest.mark.parametrize("c_in,c_out,k,dil,pad,dtype,route", PLAN_SHAPES)
def test_int8_plan_fits(c_in, c_out, k, dil, pad, dtype, route):
    plan = int8_conv.int8_plan(c_in, c_out, k, dil, pad, dtype)
    assert plan["route"] == route
    assert c_out % plan["cb"] == 0 and plan["cb"] in (16, 32, 64, 128)
    assert plan["smem"] <= 232448
    if route == "wgmma":
        assert c_in % plan["kw"] == 0 and plan["kw"] in (32, 64, 128)
        assert 2 <= plan["stages"] <= 4
        assert plan["smem"] == int8_conv.wgmma_plan_bytes(
            c_in, k, dil, plan["cb"], plan["kw"], plan["stages"], dtype)
        # the resident weights of one column block are part of the budget
        assert plan["smem"] > k * c_in * plan["cb"]
    else:
        assert plan["kw"] == plan["stages"] == 0
        assert plan["smem"] == int8_conv.mma_plan_bytes(c_in, k, dil,
                                                        plan["cb"])


def test_int8_plan_main_path_shapes():
    """The flagship's dequant convs keep every weight of all 128 output
    channels resident beside a 4-stage ring; so does the Pallas shape."""
    assert int8_conv.int8_plan(128, 128, 5, 1, "same", torch.bfloat16) == \
        dict(route="wgmma", cb=128, kw=128, stages=4, smem=219776)
    assert int8_conv.int8_plan(128, 128, 5, 3, "same", torch.int8) == \
        dict(route="wgmma", cb=128, kw=128, stages=4, smem=142912)
    # bytes by hand: weights 81,920; ring 4 x 2 x 9,216; s8 tiles
    # 3 x 9,216; output buffers 2 x 16,384; parameters 2,560; mbarriers
    # 64 + 48 + 16; slack 1,024
    assert (81920 + 4 * 18432 + 3 * 9216 + 32768 + 2560 + 64 + 48 + 16
            + 1024) == 219776
    # the requant form: 76-row s8 stages of 10,240 B, no s8 tiles, s8
    # output buffers of 8,192 B
    assert (81920 + 4 * 10240 + 2 * 8192 + 2560 + 64 + 1024) == 142912


@pytest.mark.parametrize("args", [
    (4096, 128, 5, 1, "same", torch.float32),   # mma: tile + one tap
    (128, 128, 5, 1, "causal", torch.bfloat16),
    (128, 128, 5, 1, "same", torch.float16),
    (128, 128, 0, 1, "same", torch.bfloat16),
])
def test_int8_plan_refuses_what_cannot_fit(args):
    with pytest.raises(ValueError):
        int8_conv.int8_plan(*args)


# (c_in, c_out, k, dilation, padding, dtype, stride, cb, kw, taps, wgs,
# ring): C_in % 16 and C_out % 16 (both once refused), the dvf conv in each
# form, C_in 24 / C_out 40 with dilation 3, an aligned C_in with a ragged
# C_out, the strided flagship-width conv1 in bf16 and f32 (all k taps
# resident: two warpgroups of one x stage each, one warpgroup in f32), and
# a C_in whose taps do not all fit (the staged kernel: stages of two taps,
# one CTA an SM; wgs and ring 0)
RAGGED_SHAPES = [
    (24, 32, 3, 1, "same", torch.bfloat16, 1, 32, 96, 3, 2, 2),
    (32, 40, 3, 1, "same", torch.bfloat16, 1, 64, 96, 3, 2, 2),
    (4, 500, 10, 1, "valid", torch.bfloat16, 1, 128, 64, 10, 2, 2),
    (4, 500, 10, 1, "valid", torch.float32, 1, 128, 64, 10, 2, 2),
    (4, 20, 10, 1, "same", torch.int8, 1, 32, 64, 10, 2, 2),
    (24, 40, 3, 3, "same", torch.bfloat16, 1, 64, 96, 3, 2, 2),
    (16, 20, 5, 1, "same", torch.float32, 1, 32, 96, 5, 2, 2),
    (128, 128, 5, 1, "same", torch.bfloat16, 2, 128, 640, 5, 2, 1),
    (128, 128, 5, 1, "same", torch.float32, 2, 128, 640, 5, 1, 1),
    (1000, 60, 10, 1, "same", torch.bfloat16, 1, 64, 2016, 2, 0, 0),
]


@pytest.mark.parametrize("c_in,c_out,k,dil,pad,dtype,stride,cb,kw,taps,wgs,"
                         "ring", RAGGED_SHAPES)
def test_int8_plan_ragged_route(c_in, c_out, k, dil, pad, dtype, stride, cb,
                                kw, taps, wgs, ring):
    """C_in or C_out not a multiple of 16, or a stride, takes the ragged
    route: the column block, the contraction (taps x C_in rounded up to 4,
    then to 32), the taps resident or a stage, and the warpgroups and x
    stages of the resident kernel that ``csrc/int8_conv.cu::ragged_cb`` /
    ``ragged_resident`` / ``resident_layout`` (else ``ragged_taps`` /
    ``ragged_layout``) compute, within the shared-memory limit."""
    plan = int8_conv.int8_plan(c_in, c_out, k, dil, pad, dtype, stride)
    esize = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}[dtype]
    if ring:
        smem = int8_conv.ragged_resident_bytes(c_in, k, dil, cb, ring, stride,
                                               esize, wgs)[1]
    else:
        smem = int8_conv.ragged_plan_bytes(c_in, k, dil, cb, taps, stride)[1]
    assert plan == dict(route="ragged", cb=cb, kw=kw, stages=taps, wgs=wgs,
                        ring=ring, smem=smem)
    assert plan["smem"] <= 232448
    cp = -(-c_in // 4) * 4
    assert kw == -(-taps * cp // 32) * 32 and cb >= min(c_out, 128)
    if ring:
        assert taps == k        # every tap resident: no restaging
        # no layout earlier in the kernel's order fits
        for w, r in ((2, 2), (2, 1), (1, 2), (1, 1)):
            if (w, r) == (wgs, ring):
                break
            assert int8_conv.ragged_resident_bytes(
                c_in, k, dil, cb, r, stride, esize, w)[1] > 232448
    else:
        # not even one warpgroup of one x stage fits beside the taps
        assert int8_conv.ragged_resident_bytes(
            c_in, k, dil, cb, 1, stride, esize, 1)[1] > 232448
        if taps < k:            # the next tap would not fit
            assert int8_conv.ragged_plan_bytes(c_in, k, dil, cb,
                                               taps + 1)[1] > 232448
    # the C entry's layout, by hand, at the dvf shape in bf16: the weights
    # (64 contraction bytes of 128 rows), 16 s32 contraction offsets, 5 x 128
    # epilogue parameters, then two warpgroups of two x stages (73 rows of
    # 8 bytes + 48, rounded to 16) and two in_mask stages (73 + 48 -> 128),
    # the s8 tile (73 rows of 4 bytes -> 304) and the output image (64 rows
    # of 128 + 8 bf16), and 1 KB of alignment slack
    if (c_in, c_out, k, dtype) == (4, 500, 10, torch.bfloat16):
        assert plan["smem"] == (64 * 128 + 64 + 20 * 128
                                + 2 * (2 * (640 + 128) + 304 + 64 * 136 * 2)
                                + 1024) == 50336
    # and at the stride shape: 640 contraction bytes of 128 rows, one x
    # stage a warpgroup (131 rows of 256 bytes + 48), the s8 tile's rows
    # padded to 136 bytes (stride 2 x 136 / 4 = 68 = 4 mod 8; 131 x 136 =
    # 17,816, rounded to 16)
    if (c_in, k, stride, dtype) == (128, 5, 2, torch.bfloat16):
        assert int8_conv.ragged_pitch(128, 2) == 136
        assert plan["smem"] == (640 * 128 + 640 + 20 * 128
                                + 2 * (33584 + 192 + 17824 + 64 * 136 * 2)
                                + 1024) == 224160


@pytest.mark.parametrize("stride", [1, 2, 3, 4])
@pytest.mark.parametrize("cp", [16, 32, 64, 96, 128, 256])
def test_ragged_pitch_spreads_banks(cp, stride):
    """The resident kernel loads A fragments as 32-bit words: lane (g, t)
    reads s8 row (r + g) * stride + j * d at byte c + 4 t of one tap (cp %
    16 == 0 keeps a 16-byte group in one tap). With ``ragged_pitch`` the 32
    lanes hit 32 distinct banks, for every row and channel offset."""
    pitch = int8_conv.ragged_pitch(cp, stride)
    assert pitch % 4 == 0 and cp <= pitch < cp + 32
    for row in range(4):
        for c in range(0, cp, 16):
            banks = {(((row + g) * stride * pitch + c + 4 * t) // 4) % 32
                     for g in range(8) for t in range(4)}
            assert len(banks) == 32, (cp, stride, row, c)


def test_int8_plan_ragged_refuses_what_cannot_fit():
    """Not even one tap of 128 output channels beside the x tile."""
    with pytest.raises(ValueError, match="ragged route"):
        int8_conv.int8_plan(2000, 500, 10, 1, "same", torch.bfloat16)


def test_int8_plan_long_box_takes_mma_route():
    """A TMA box of 64 + d(k-1) rows is at most 256, and the ring must fit
    beside the weights: beyond either the plan names the mma route before
    any launch."""
    plan = int8_conv.int8_plan(128, 128, 5, 48, "same", torch.int8)
    assert plan["route"] == "wgmma"
    plan = int8_conv.int8_plan(128, 128, 5, 49, "same", torch.int8)
    assert plan["route"] == "mma"
    # in bf16 the 256-row stages and s8 tiles do not fit beside the weights
    plan = int8_conv.int8_plan(128, 128, 5, 48, "same", torch.bfloat16)
    assert plan["route"] == "mma"


# --- (c) the layers ------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding,dilation",
                         [("same", 1), ("same", 3), ("valid", 3)])
def test_masked_conv_int8_matches_jax(dt, padding, dilation):
    rng = np.random.default_rng(20 + dilation)
    b, f, length, c_in, c_out, k = 2, 3, 40, 16, 32, 3
    x = rng.normal(size=(b, f, length, c_in)).astype(np.float32)
    mask = rng.random((b, f, length)) > 0.2
    params = {"kernel": (rng.normal(size=(k, c_in, c_out)) * 0.2).astype(
        np.float32), "bias": (rng.normal(size=c_out) * 0.1).astype(np.float32)}
    absmax = np.abs(np.where(mask[..., None], x, 0)).max()
    quant = _build_quant_tree({"c": params}, {"c": {"absmax": absmax}})["c"]
    jconv = JL.MaskedConv1D(filters=c_out, kernel_size=k, padding=padding,
                            dilation_rate=dilation, activation="gelu",
                            dtype=JDT[dt])
    want, want_m = jconv.apply({"params": params, "quant": quant},
                               jnp.asarray(x).astype(JDT[dt]),
                               jnp.asarray(mask))
    conv = TL.MaskedConv1D(c_in, c_out, k, padding=padding,
                           dilation_rate=dilation, activation="gelu",
                           dtype=TDT[dt])
    load_state(conv, params_from_jax({"params": params, "quant": quant}))
    assert conv.int8 and conv.kernel_q.dtype == torch.int8
    got, got_m = conv(torch.from_numpy(x).to(TDT[dt]),
                      torch.from_numpy(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    _assert_close(got.float().numpy(), np.asarray(want, np.float32),
                  LAYER_TOL[dt], (dt, padding, dilation))


def _block_variables(norm, x, mask, dt):
    """A JAX ResidualBlock's randomized variables with the quant
    collection its own calibration sow gives."""
    c = x.shape[-1]
    blk = JL.ResidualBlock(filters=c, kernel_size=5, norm_type=norm)
    variables = blk.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mask))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, variables))
    _, mut = blk.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                       mutable=["calib"])
    calib = jax.tree_util.tree_map(np.asarray, mut["calib"])
    quant = _build_quant_tree(variables["params"], calib)
    assert set(quant) == {"conv1", "conv2"}
    return dict(variables, quant=quant), calib


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["masked_dyt", "masked_batchnorm"])
def test_residual_block_int8_matches_jax(dt, norm):
    rng = np.random.default_rng(30)
    b, f, length, c = 2, 2, 48, 32
    x = rng.normal(size=(b, f, length, c)).astype(np.float32)
    mask = rng.random((b, f, length)) > 0.15
    mask[0, 0, :12] = False
    variables, calib = _block_variables(norm, x, mask, dt)
    jblk = JL.ResidualBlock(filters=c, kernel_size=5, norm_type=norm,
                            dtype=JDT[dt])
    want, want_m = jblk.apply(variables, jnp.asarray(x).astype(JDT[dt]),
                              jnp.asarray(mask))
    blk = TL.ResidualBlock(c, c, kernel_size=5, norm_type=norm,
                           dtype=TDT[dt])
    load_state(blk, params_from_jax(variables))
    assert blk.conv1.int8 and blk.conv2.int8
    with torch.inference_mode():
        got, got_m = blk(torch.from_numpy(x).to(TDT[dt]),
                         torch.from_numpy(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    _assert_close(got.float().numpy(), np.asarray(want, np.float32),
                  LAYER_TOL[dt], (dt, norm))

    if dt == "float32":
        # calibration mode records what the JAX sow records, and leaves
        # no state behind
        flt = TL.ResidualBlock(c, c, kernel_size=5, norm_type=norm)
        load_state(flt, params_from_jax(
            {k: v for k, v in variables.items() if k != "quant"}))
        keys = set(flt.state_dict())
        with TL.calibrating(flt) as records, torch.inference_mode():
            flt(torch.from_numpy(x), torch.from_numpy(mask))
        assert set(records) == {"conv1", "conv2"}
        for name, v in records.items():
            np.testing.assert_allclose(v.item(), calib[name]["absmax"],
                                       rtol=1e-6)
        assert set(flt.state_dict()) == keys
        assert all(m.calib is None for m in flt.modules()
                   if isinstance(m, TL.MaskedConv1D))


# --- (d) whole models ------------------------------------------------------------

def _jax_bundle(tmp, cfg, seed):
    """A saved JAX model (randomized non-kernel leaves) and its JAX
    full_int8 quantization."""
    _, variables = ModelBuilder(cfg).init()
    variables = _randomize(jax.tree_util.tree_map(np.asarray, variables),
                           seed)
    path = tmp / cfg["model"]["name"]
    jax_save_model(variables, cfg, path)
    qpath = tmp / f"{cfg['model']['name']}_int8"
    stats = jax_quantize(path, qpath, mode="full_int8")
    assert stats["int8_exec_convs"] >= 2
    return path, qpath


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_bundles")
    return {"cfg": _jax_bundle(tmp, copy.deepcopy(CFG), 1),
            "dyt": _jax_bundle(tmp, copy.deepcopy(DYT_CFG), 2)}


def _programs(model_cfg, crop, rng):
    n = 6
    dense = (rng.integers(0, 4, size=(n, crop)).astype(np.uint8),
             np.full(n, crop, np.int32))
    b = rng.integers(0, 9, size=(n, crop)).astype(np.uint8)
    masked = (b, np.array([crop, crop // 2, crop - 7, 30, crop, crop],
                          np.int32))
    b = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    b[:, crop // 3] = 4                      # one interior N per row
    progs = [("dense", dense, {"assume_dense": True}), ("masked", masked, {})]
    for cut, _, _ in mask_cut_plan(model_cfg["representation_learner"]) or []:
        progs.append((f"bounded_{cut}", (b, np.full(n, crop, np.int32)),
                      {"mask_layers": cut}))
    return progs


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["cfg", "dyt"])
def test_full_int8_bundle_matches_jax(bundles, which, dt):
    _, qpath = bundles[which]
    jm, jvars, config, _ = jax_load_quantized(qpath, dtype=JDT[dt])
    assert "quant" in jvars
    model, _, _ = load_model(qpath, dtype=TDT[dt], device="cpu")
    assert int8_conv_count(model) == len(jax.tree_util.tree_leaves(
        jvars["quant"])) // 3
    progs = _programs(config["model"], model.crop_nt,
                      np.random.default_rng(5))
    if which == "dyt":
        assert any(p[0].startswith("bounded") for p in progs)
    tol = MODEL_TOL[dt]
    for name, (bases, lengths), kw in progs:
        want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                                "lengths": jnp.asarray(lengths)},
                        train=False, **kw)
        with torch.inference_mode():
            got = model(torch.from_numpy(bases), torch.from_numpy(lengths),
                        **kw)
        assert set(got) == set(want), name
        for key in want:
            a = np.asarray(want[key], np.float32)
            b = got[key].float().numpy()
            if dt == "float32":
                # rounding-boundary flips: see the module docstring
                scale = max(float(np.abs(a).max()), 1e-6)
                assert np.median(np.abs(b - a)) <= 1e-5 * scale, (name, key)
            _assert_close(b, a, tol, (name, key))
        pred = np.asarray(want["prediction"], np.float32)
        scale = float(np.abs(pred).max())
        top2 = np.sort(pred, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol * scale
        np.testing.assert_array_equal(
            got["prediction"].float().numpy().argmax(-1)[clear],
            pred.argmax(-1)[clear])


# --- (e) quantize_bundle ------------------------------------------------------------

def test_quantize_bundle_matches_jax(bundles, tmp_path):
    path, jax_q = bundles["dyt"]
    jax_quantize(path, tmp_path / "jax_dyn", mode="dynamic")
    quantize_bundle(path, tmp_path / "dyn", mode="dynamic", device="cpu")
    want = read_flax_msgpack(tmp_path / "jax_dyn" / "params_int8.msgpack")
    got = read_flax_msgpack(tmp_path / "dyn" / "params_int8.msgpack")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for p, v in flat_w:
        assert flat_g[p].dtype == v.dtype, p
        np.testing.assert_array_equal(flat_g[p], v, err_msg=str(p))

    stats = quantize_bundle(path, tmp_path / "full", mode="full_int8",
                            device="cpu")
    assert stats["int8_exec_convs"] == 4
    want = read_flax_msgpack(jax_q / "params_int8.msgpack")["quant"]
    got = read_flax_msgpack(tmp_path / "full" / "params_int8.msgpack")[
        "quant"]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g) == 12
    for p, v in flat_w:
        if p[-1].key == "act_scale":
            np.testing.assert_allclose(flat_g[p], v, rtol=1e-2)
        else:
            np.testing.assert_array_equal(flat_g[p], v, err_msg=str(p))
    # the JAX package loads the port's bundle and runs it int8
    _, jvars, _, _ = jax_load_quantized(tmp_path / "full")
    assert len(jax.tree_util.tree_leaves(jvars["quant"])) == 12


# --- (f) the engine ------------------------------------------------------------

def test_int8_auto_engine_routing(bundles):
    path, qpath = bundles["cfg"]
    bf16 = torch.bfloat16
    flt_model, _, _ = load_model(path, dtype=bf16, device="cpu")
    q_model, _, _ = load_model(qpath, dtype=bf16, device="cpu")
    crop = q_model.crop_nt
    auto = InferenceEngine(flt_model, batch_size=8, device="cpu",
                           int8_model=q_model)
    flt = InferenceEngine(flt_model, batch_size=8, device="cpu")
    full8 = InferenceEngine(q_model, batch_size=8, device="cpu")
    rng = np.random.default_rng(3)

    dense = rng.integers(0, 4, size=(8, crop)).astype(np.uint8)
    lengths = np.full(8, crop, np.int32)
    out_auto = auto.predict_windows(dense, lengths)
    out_int8 = full8.predict_windows(dense, lengths)
    out_flt = flt.predict_windows(dense, lengths)
    assert auto.int8_forwards == 1
    for k in out_auto:
        assert np.array_equal(out_auto[k], out_int8[k]), k
    assert not all(np.array_equal(out_int8[k], out_flt[k]) for k in out_int8)

    # short windows in most rows: too many for a split bucket
    short = rng.integers(0, 4, size=(8, crop)).astype(np.uint8)
    short_len = rng.integers(crop // 2, crop, size=8).astype(np.int32)
    for i, ln in enumerate(short_len):
        short[i, ln:] = 4
    out_auto = auto.predict_windows(short, short_len)
    out_flt = flt.predict_windows(short, short_len)
    assert auto.int8_forwards == 1           # masked: the float model
    for k in out_auto:
        assert np.array_equal(out_auto[k], out_flt[k]), k


def test_int8_auto_split_batch_clean_rows_take_int8(bundles):
    path, qpath = bundles["cfg"]
    bf16 = torch.bfloat16
    flt_model, _, _ = load_model(path, dtype=bf16, device="cpu")
    q_model, _, _ = load_model(qpath, dtype=bf16, device="cpu")
    crop = q_model.crop_nt
    bs = 32
    bases = np.random.default_rng(4).integers(0, 4, size=(bs, crop)).astype(
        np.uint8)
    bases[5, crop // 2] = 4                  # two masked rows: a bucket of 2
    bases[20, 1] = 4
    lengths = np.full(bs, crop, np.int32)
    masked = np.zeros(bs, bool)
    masked[[5, 20]] = True
    auto = InferenceEngine(flt_model, batch_size=bs, device="cpu",
                           int8_model=q_model)
    full8 = InferenceEngine(q_model, batch_size=bs, device="cpu")
    flt = InferenceEngine(flt_model, batch_size=bs, device="cpu")
    out_auto = auto.predict_windows(bases, lengths)
    assert set(auto.program_counts) == {(bs, "dense"), (bs // 16, "masked")}
    assert auto.int8_forwards == 1           # the dense base, not the bucket
    out_int8 = full8.predict_windows(bases, lengths)
    out_flt = flt.predict_windows(bases, lengths)
    for k in out_auto:
        assert np.array_equal(out_auto[k][~masked], out_int8[k][~masked]), k
        assert np.array_equal(out_auto[k][masked], out_flt[k][masked]), k


# --- (g) run_core ------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_int8(tmp_path_factory):
    """A copy of the demo bundle and its JAX-made full_int8 bundle beside
    it (``<model>_int8``, where ``--int8`` finds it)."""
    tmp = tmp_path_factory.mktemp("demo_int8")
    shutil.copytree(DEMO, tmp / "demo")
    jax_quantize(tmp / "demo", tmp / "demo_int8", mode="full_int8")
    return tmp / "demo", tmp / "demo_int8"


@pytest.mark.parametrize("mode", ["full", "auto"])
def test_run_core_int8_tsv_matches_jax(demo_int8, tmp_path, mode):
    demo, qpath = demo_int8
    common = dict(input_path=str(FASTA), fsize=2000, stride=1500, batch=96,
                  precision="float32", reliability_cutoff=0.1,
                  phage_score=3.0)
    jax_table = jax_run_core(
        output_dir=str(tmp_path / "jax"),
        model_path=str(qpath if mode == "full" else demo),
        int8_auto_path=str(qpath) if mode == "auto" else None, **common)
    table = run_core(output_dir=str(tmp_path / "torch"),
                     model_path=str(demo), int8=mode, device="cpu",
                     workers=1, **common)
    want = jax_table.read_bytes()
    assert want.count(b"\n") == 10
    assert table.read_bytes() == want


def test_run_core_int8_refusals(demo_int8, tmp_path):
    demo, _ = demo_int8
    with pytest.raises(FileNotFoundError, match="no int8 bundle"):
        run_core(str(FASTA), str(tmp_path), str(DEMO), int8="full",
                 device="cpu")
    dyn = tmp_path / "dyn"
    quantize_bundle(demo, dyn, mode="dynamic")
    with pytest.raises(ValueError, match="needs a full_int8 bundle"):
        run_core(str(FASTA), str(tmp_path / "o"), str(dyn), int8="auto",
                 device="cpu")


# --- (h) without JAX and ml_dtypes ---------------------------------------------------

def test_bundles_load_without_jax_or_ml_dtypes(demo_int8, tmp_path):
    demo, qpath = demo_int8
    jax_quantize(demo, tmp_path / "f16", mode="float16")
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
               "jaeger_tpu")
    code = (
        "import sys\n"
        f"for m in {blocked!r}:\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from jaeger_tpu_torch.models.artifacts import load_model\n"
        "from jaeger_tpu_torch.models.conversion import int8_conv_count\n"
        f"m16, _, _ = load_model({str(tmp_path / 'f16')!r}, device='cpu')\n"
        f"m8, _, _ = load_model({str(qpath)!r}, device='cpu')\n"
        "k = m16.state_dict()['rep.masked_conv1d_0.kernel']\n"
        "print('f16', k.dtype, float(k.double().abs().sum()))\n"
        "print('int8', int8_conv_count(m8))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    # the bf16 leaves widen exactly: the JAX package's own bf16 rounding
    want = np.asarray(jax.tree_util.tree_map(
        np.asarray, read_flax_msgpack(tmp_path / "f16" / "params.msgpack"))[
        "params"]["rep"]["masked_conv1d_0"]["kernel"], np.float64)
    kernel = np.asarray(read_flax_msgpack(DEMO / "params.msgpack")["params"][
        "rep"]["masked_conv1d_0"]["kernel"], np.float32)
    np.testing.assert_array_equal(
        want, np.asarray(jnp.asarray(kernel).astype(jnp.bfloat16),
                         np.float64))
    dtype, total = lines["f16"].split()
    assert dtype == "torch.float32"
    np.testing.assert_allclose(float(total), np.abs(want).sum(), rtol=1e-12)
    assert lines["int8"] == "4"              # the demo's residual convs
