"""int8 execution of the layer-zoo templates in the port against jaeger_tpu.

The narrow dvf (nucleotide input, one shared-weight conv per strand on the
``int8_conv`` ragged route: C_in 4, k 10, VALID), cross-frame and axial
templates of ``tests/test_torch_templates.py``, a narrow model with a
``multi_scale_conv`` entry and ``parallel_branches`` of convs, and a
narrow model with a ``residual_block`` of ``strides: 2`` (its ``conv1``
and ``conv_bypass`` strided, on the ragged route's stride). These tests
replace ``test_torch_templates.py::test_int8_refused_for_layer_zoo``, which
pinned the refusal the port no longer has. On the CPU:

* the ``quant`` tree the port's ``quantize_bundle(mode="full_int8")``
  writes has JAX's paths; ``kernel_q`` and ``w_scale`` equal, each
  ``act_scale`` within 1 % (``test_torch_int8.py::
  test_quantize_bundle_matches_jax``: the bf16 calibration forwards round
  at other places on the two sides); the JAX package loads the bundle;
* the int8 forward of JAX's bundle, f32, dense and masked programs, equals
  JAX's ``load_quantized`` apply to 1e-5 of each output's scale. Both
  sides' int8 conv inputs are captured and quantized: where an upstream
  f32 sum differs in its last bit, one input can land on the other side of
  a rounding boundary and take another int8 step, which moves that
  window's outputs by up to ``act_scale * w_scale * 127`` (about 1 % of the
  conv's output scale; ``test_torch_int8.py`` (d)). Such a flip is counted,
  and only a forward with flips is held to the median within 1e-5 and
  every element within 1e-2 of the scale;
* ``run_core --int8`` and ``--int8 auto`` at f32 give TSVs byte-identical
  to JAX ``run_core``'s (JAX with ``devices=1``) for the dvf and the
  cross-frame templates;
* the plain int8 conv's stride equals ``F.conv1d`` on int-valued tensors
  (XLA's SAME and VALID padding).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from jaeger_tpu.commands.predict import run_core as jax_run_core
from jaeger_tpu.models import layers as JL
from jaeger_tpu.models.artifacts import save_model as jax_save_model
from jaeger_tpu.models.conversion import load_quantized as jax_load_quantized
from jaeger_tpu.models.conversion import quantize_bundle as jax_quantize
from jaeger_tpu_torch.commands.predict import run_core
from jaeger_tpu_torch.models import layers as TL
from jaeger_tpu_torch.models.artifacts import load_model, read_flax_msgpack
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.models.conversion import (int8_conv_count,
                                                quantize_bundle)
from jaeger_tpu_torch.ops import int8_conv
from test_torch_templates import _bases, _variables, narrow

FASTA = "jaeger_tpu/data/test/test_contigs.fasta"
TOL = 1e-5
FLIP_TOL = 1e-2


def multiscale_config() -> dict:
    """A narrow model whose convs sit in a multi-scale entry conv (its
    input the embedding, not folded) and in two parallel branches (a
    dilated one among them)."""
    branch_a = [{"name": "masked_conv1d", "config": {
        "filters": 16, "kernel_size": 3, "padding": "same"}},
        {"name": "relu"}]
    branch_b = [{"name": "masked_conv1d", "config": {
        "filters": 8, "kernel_size": 5, "padding": "same",
        "dilation_rate": 2}}]
    return {"model": {
        "name": "multiscale_int8",
        "classifier_out_dim": 3,
        "class_label_map": [{"class": c, "label": i} for i, c in
                            enumerate(["chromosome", "phage", "plasmid"])],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 16},
        "string_processor": {"crop_size": 40, "codon": "CODON"},
        "representation_learner": {"hidden_layers": [
            {"name": "multi_scale_conv", "config": {"branches": [
                {"filters": 8, "kernel_size": 3},
                {"filters": 8, "kernel_size": 5}]}},
            {"name": "masked_batchnorm"},
            {"name": "gelu"},
            {"name": "parallel_branches", "config": {
                "merge": "concat", "branches": [
                    {"hidden_layers": branch_a},
                    {"hidden_layers": branch_b}]}},
            {"name": "gelu"}], "pooling": "max"},
        "classifier": {"hidden_layers": [
            {"name": "dense", "config": {"units": 3}}]},
    }, "training": {}}


def strided_config() -> dict:
    """A narrow model whose residual block has ``strides: 2``: its conv1
    (k 3, 16 -> 24 channels) and its 1x1 conv_bypass are strided; conv2
    is not."""
    return {"model": {
        "name": "strided_int8",
        "classifier_out_dim": 3,
        "class_label_map": [{"class": c, "label": i} for i, c in
                            enumerate(["chromosome", "phage", "plasmid"])],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 16},
        "string_processor": {"crop_size": 40, "codon": "CODON"},
        "representation_learner": {"hidden_layers": [
            {"name": "masked_conv1d",
             "config": {"filters": 16, "kernel_size": 5}},
            {"name": "masked_batchnorm"},
            {"name": "gelu"},
            {"name": "residual_block", "config": {
                "block_size": 1, "filters": 24, "kernel_size": 3,
                "strides": 2}},
            {"name": "gelu"}], "pooling": "max"},
        "classifier": {"hidden_layers": [
            {"name": "dense", "config": {"units": 3}}]},
    }, "training": {}}


MODELS = ("dvf", "crossframe", "axial", "multiscale", "strided")
#: int8 convs each narrow model has: the dvf conv; two residual convs; the
#: multi-scale conv's two branches and one conv in each parallel branch;
#: the strided block's conv1, conv2 and conv_bypass
INT8_CONVS = {"dvf": 1, "crossframe": 2, "axial": 2, "multiscale": 4,
              "strided": 3}


def _config(name: str) -> dict:
    if name == "strided":
        return strided_config()
    cfg = multiscale_config() if name == "multiscale" else narrow(name)
    cfg["model"].setdefault("name", f"{name}_int8")
    return cfg


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """name -> (config, float bundle, JAX full_int8 bundle, the port's
    full_int8 bundle)."""
    tmp = tmp_path_factory.mktemp("int8_zoo")
    out = {}
    for i, name in enumerate(MODELS):
        cfg = _config(name)
        path = tmp / name
        jax_save_model(_variables(cfg, 40 + i), copy.deepcopy(cfg), path)
        jax_quantize(path, tmp / f"{name}_int8", mode="full_int8")
        quantize_bundle(path, tmp / f"{name}_port_int8", mode="full_int8",
                        device="cpu")
        out[name] = (cfg, path, tmp / f"{name}_int8",
                     tmp / f"{name}_port_int8")
    return out


@pytest.mark.parametrize("name", MODELS)
def test_quant_tree_matches_jax(bundles, name):
    _, _, jax_q, port_q = bundles[name]
    want = read_flax_msgpack(jax_q / "params_int8.msgpack")["quant"]
    got = read_flax_msgpack(port_q / "params_int8.msgpack")["quant"]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g) == 3 * INT8_CONVS[name]
    for p, v in flat_w:
        assert flat_g[p].dtype == v.dtype, p
        if p[-1].key == "act_scale":
            np.testing.assert_allclose(flat_g[p], v, rtol=1e-2)
        else:
            np.testing.assert_array_equal(flat_g[p], v, err_msg=str(p))
    # the JAX package loads the port's bundle and runs it int8
    _, jvars, _, _ = jax_load_quantized(port_q)
    assert len(jax.tree_util.tree_leaves(jvars["quant"])) == \
        3 * INT8_CONVS[name]


def _jax_int8_inputs(model, jvars, inputs, **kw):
    """JAX's apply, and the int8 values of every int8 conv's input in call
    order (``layers.py:228-252``: the masked input, times ``1 /
    act_scale`` in f32, rounded and clipped)."""
    seen = []

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, JL.MaskedConv1D)
                and context.method_name == "__call__"
                and mod.has_variable("quant", "kernel_q")
                and kwargs.get("fold_table") is None):
            x = np.asarray(args[0], np.float32)
            mask = args[1] if len(args) > 1 else kwargs.get("mask")
            if mod.use_masking and mask is not None:
                x = np.where(np.asarray(mask)[..., None], x, 0.0)
            inv = np.float32(1.0) / np.asarray(
                mod.get_variable("quant", "act_scale"), np.float32)
            seen.append(np.clip(np.round(x.reshape(-1, x.shape[-1]) * inv),
                                -127, 127))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        out = model.apply(jvars, inputs, train=False, **kw)
    return out, seen


def _port_int8_inputs(model, bases, lengths, **kw):
    """The port's forward, and the int8 values of every int8 conv's
    input in call order, as the kernel quantizes them."""
    seen = []
    launch = TL.int8_conv_dequant

    def record(x, w, inv_act, dq, *args, in_mask=None, **kwargs):
        q = int8_conv.quantize_activation(x, inv_act)
        if in_mask is not None:
            q = torch.where(in_mask[..., None], q, torch.zeros(()))
        seen.append(q.reshape(-1, q.shape[-1]).numpy())
        return launch(x, w, inv_act, dq, *args, in_mask=in_mask, **kwargs)

    TL.int8_conv_dequant = record
    try:
        with torch.inference_mode():
            out = model(torch.from_numpy(bases), torch.from_numpy(lengths),
                        **kw)
    finally:
        TL.int8_conv_dequant = launch
    return out, seen


@pytest.mark.parametrize("program", ["dense", "masked"])
@pytest.mark.parametrize("name", MODELS)
def test_int8_forward_matches_jax(bundles, name, program):
    _, _, jax_q, _ = bundles[name]
    jm, jvars, _, _ = jax_load_quantized(jax_q, dtype=jnp.float32)
    model, _, _ = load_model(jax_q, device="cpu")
    assert int8_conv_count(model) == INT8_CONVS[name]
    bases, lengths = _bases(np.random.default_rng(17), model.crop_nt,
                            program)
    kw = {"assume_dense": True} if program == "dense" else {}
    want, want_q = _jax_int8_inputs(
        jm, jvars, {"bases": jnp.asarray(bases),
                    "lengths": jnp.asarray(lengths)}, **kw)
    got, got_q = _port_int8_inputs(model, bases, lengths, **kw)
    # dvf: one call per strand of the shared conv
    assert len(got_q) == len(want_q) == INT8_CONVS[name] * (
        2 if name == "dvf" else 1)
    if name == "strided":
        # the port's block runs conv_bypass before conv2 (the shortcut
        # rides conv2's epilogue); JAX runs conv1, conv2, conv_bypass
        got_q = [got_q[0], got_q[2], got_q[1]]
    flips = 0
    for g, w in zip(got_q, want_q):
        assert g.shape == w.shape
        assert np.abs(g - w).max(initial=0) <= 1
        flips += int((g != w).sum())
    assert flips <= 4, f"{flips} int8 inputs differ"
    assert set(got) == set(want)
    for k in want:
        a = np.asarray(want[k], np.float32)
        b = got[k].numpy()
        scale = max(float(np.abs(a).max()), 1e-6)
        if flips == 0:
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL * scale,
                                       err_msg=f"{name} {program} {k}")
        else:
            assert np.median(np.abs(b - a)) <= TOL * scale, (name, k)
            np.testing.assert_allclose(b, a, rtol=0, atol=FLIP_TOL * scale,
                                       err_msg=f"{name} {program} {k}")


@pytest.mark.parametrize("mode", ["full", "auto"])
@pytest.mark.parametrize("name", ["dvf", "crossframe"])
def test_run_core_int8_tsv_matches_jax(bundles, tmp_path, name, mode):
    cfg, path, jax_q, _ = bundles[name]
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    common = dict(input_path=FASTA, fsize=crop, stride=crop, batch=512,
                  precision="float32")
    # JAX's CLI resolves `<model>_int8` as the port does
    want = jax_run_core(
        output_dir=str(tmp_path / "jax"), devices=1,
        model_path=str(jax_q if mode == "full" else path),
        int8_auto_path=str(jax_q) if mode == "auto" else None, **common)
    got = run_core(output_dir=str(tmp_path / "torch"), model_path=str(path),
                   int8=mode, device="cpu", workers=1, **common)
    assert want.read_bytes().count(b"\n") == 10
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("length,k,dil,stride,padding", [
    (37, 3, 1, 2, "same"), (40, 5, 2, 2, "same"), (41, 1, 1, 2, "same"),
    (50, 4, 1, 3, "valid"), (33, 10, 1, 2, "valid"), (64, 3, 3, 4, "same")])
def test_plain_int8_conv_stride_matches_conv1d(length, k, dil, stride,
                                               padding):
    """The plain version's stride against ``F.conv1d`` on int-valued
    float64 tensors with XLA's padding (every sum exact), in both forms."""
    gen = torch.Generator().manual_seed(length * k + stride)
    q = torch.randint(-127, 128, (3, length, 5), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, 5, 7), generator=gen, dtype=torch.int8)
    l_out, pad_l, pad_r = int8_conv.conv_geometry(length, k, dil, padding,
                                                  stride)
    want = F.conv1d(F.pad(q.double().transpose(1, 2), (pad_l, pad_r)),
                    w.double().permute(2, 1, 0), stride=stride,
                    dilation=dil).transpose(1, 2)
    assert want.shape[1] == l_out
    if padding == "same":
        assert l_out == -(-length // stride)
        got = int8_conv.int8_conv_requant(q, w, 1.0, dilation=dil,
                                          stride=stride)
        ref = torch.clamp(torch.round(want.float()), -127, 127)
        assert torch.equal(got.float(), ref)
    dq = torch.ones(7)
    got = int8_conv.int8_conv_dequant(q.float(), w, 1.0, dq, dilation=dil,
                                      padding=padding, stride=stride)
    assert torch.equal(got.double(), want)
    assert int8_conv.int8_plan(5, 7, k, dil, padding, torch.bfloat16,
                               stride)["route"] == "ragged"
    if stride > 1:
        assert int8_conv.int8_plan(16, 32, k, dil, padding, torch.bfloat16,
                                   stride)["route"] == "ragged"
