"""The port's route to its hand kernels, and three small faults of
``predict``, on the CPU against jaeger_tpu.

* The residual convs' route (``MaskedConv1D.fused``): a conv reaches
  ``fused_conv_block`` only when ``conv_plan`` takes its shape, and in
  training only when ``check_wgrad_shape`` takes it too (odd k). Every
  refused shape (C 40 in either dtype, C 192 in f32, k 7 and C 96 in bf16
  training, an even k in training) takes cuDNN's conv with the torch
  epilogue, on every device alike; the forward of a C 40 model and one
  train step of an even-k C 40 model equal JAX's at f32 with the
  tolerances of ``tests/test_torch_templates.py``.
* ``predict`` logs JAX's WARNING when ``--fsize`` gives fewer codon frames
  than the model's crop (the demo bundle at ``--fsize 400``).
* ``predict --int8`` without an int8 bundle exits 2 with the message, as
  JAX's click ``UsageError`` does, for a bundle and for an ensemble.

``tests/test_torch_int8_zoo.py`` holds the int8 execution of strided
convs (the ``ragged`` route's stride) against JAX.
"""

import copy
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jaeger_tpu.commands.predict import run_core as jax_run_core
from jaeger_tpu_torch.commands.predict import BUNDLED_DEMO_MODEL, run_core
from jaeger_tpu_torch.models import layers as TL
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.ops.fused_conv import conv_plan
from jaeger_tpu_torch.ops.fused_conv_grad import check_wgrad_shape
from test_torch_templates import (_bases, _check_step, _forward_matches_jax,
                                  _variables)

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32

#: (C, k, dtype, train): each shape one of the kernels' plans refuses
REFUSED = [
    (40, 3, BF16, False),       # conv_plan: C % 16
    (40, 3, F32, False),
    (192, 3, F32, False),       # conv_plan: f32 C > 128 and C % 128
    (128, 7, BF16, True),       # check_wgrad_shape: bf16 k in (3, 5)
    (96, 3, BF16, True),        # check_wgrad_shape: bf16 C % 64
    (128, 4, BF16, True),       # check_wgrad_shape: odd k
    (48, 4, F32, True),
]
#: shapes the plans take
ACCEPTED = [(128, 5, BF16, False), (128, 5, BF16, True), (96, 3, BF16, False),
            (48, 3, F32, True), (192, 3, BF16, False), (128, 4, F32, False)]


def _block(c, k):
    return TL.ResidualBlock(c, c, kernel_size=k, norm_type="masked_dyt")


@pytest.mark.parametrize("c,k,dtype,train", REFUSED)
def test_route_refuses_what_the_plans_refuse(c, k, dtype, train):
    with pytest.raises(ValueError):
        conv_plan(c, k, dtype)
        if train:
            check_wgrad_shape(c, k, dtype)
    conv = _block(c, k).conv1
    assert conv.fusable
    assert not conv.fused(dtype, train)


@pytest.mark.parametrize("c,k,dtype,train", ACCEPTED)
def test_route_takes_what_the_plans_take(c, k, dtype, train):
    conv_plan(c, k, dtype)
    if train:
        check_wgrad_shape(c, k, dtype)
    assert _block(c, k).conv1.fused(dtype, train)


@pytest.mark.parametrize("c,k,train,launches", [
    (40, 3, False, 0), (48, 3, False, 2), (48, 4, True, 0), (48, 3, True, 2)])
def test_residual_block_calls_the_kernel_only_where_planned(
        monkeypatch, c, k, train, launches):
    """The block's two convs reach ``fused_conv_block`` (the training
    wrapper in train mode) exactly when the route takes them."""
    calls = []
    name = "fused_conv_block_train" if train else "fused_conv_block"
    real = getattr(TL, name)

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(TL, name, spy)
    block = _block(c, k)
    gen = torch.Generator().manual_seed(0)
    for p in block.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.1
        p.requires_grad_(train)
    x = torch.randn(2, 6, 20, c, generator=gen, requires_grad=train)
    mask = torch.ones(2, 6, 20, dtype=torch.bool)
    mask[0, :, 15:] = False
    y, _ = block(x, mask, train=train)
    if train:
        y.sum().backward()
        assert x.grad is not None
    assert len(calls) == launches


def _residual_config(filters: int, kernel_size: int) -> dict:
    """A small fragment model: a k5 entry conv, masked batch norm, one
    ``residual_block`` of ``filters`` channels and ``kernel_size`` taps,
    average pooling, 3 classes, a 40-codon crop."""
    return {"model": {
        "name": f"route_c{filters}_k{kernel_size}",
        "classifier_out_dim": 3,
        "class_label_map": [{"class": c, "label": i} for i, c in
                            enumerate(["chromosome", "phage", "plasmid"])],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 8},
        "string_processor": {"crop_size": 40},
        "representation_learner": {"hidden_layers": [
            {"name": "masked_conv1d",
             "config": {"filters": filters, "kernel_size": 5}},
            {"name": "masked_batchnorm", "config": {}},
            {"name": "gelu"},
            {"name": "residual_block",
             "config": {"block_size": 1, "filters": filters,
                        "kernel_size": kernel_size}},
            {"name": "gelu"}], "pooling": "average"},
        "classifier": {"hidden_layers": [
            {"name": "dense", "config": {"units": 3, "dtype": "float32"}}]},
    }, "training": {
        "optimizer": "adam", "optimizer_params": {"learning_rate": 0.003},
        "loss_classifier": "categorical_crossentropy",
        "loss_params_classifier": {"from_logits": True}}}


@pytest.mark.parametrize("filters,kernel_size", [(40, 3), (40, 4)])
def test_refused_shape_forward_matches_jax(filters, kernel_size):
    """C 40 (``conv_plan`` refuses it) in the masked program, at f32."""
    _forward_matches_jax(_residual_config(filters, kernel_size), 51)


@pytest.mark.parametrize("program", ["dense", "masked"])
def test_even_k_train_step_matches_jax(program):
    """One train step of a C 40, k 4 residual block: the port raised
    ``NotImplementedError`` at the first step, JAX trains it."""
    from jaeger_tpu.models.builder import ModelBuilder

    cfg = _residual_config(40, 4)
    variables = _variables(cfg, 52)
    rng = np.random.default_rng(53)
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    bases, lengths = _bases(rng, crop, program)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=6)]
    common = dict(loss_name="categorical_crossentropy",
                  loss_params={"from_logits": True}, heads=("prediction",))
    if program == "dense":
        common["assume_dense"] = True
    _check_step(cfg, ModelBuilder(copy.deepcopy(cfg)).build(), variables,
                {"bases": bases, "lengths": lengths, "labels": labels},
                common, 0.003)


def test_refused_shape_loads_into_port_model():
    """A bf16 model with C 40 builds and runs its residual convs off the
    kernel (the route answers before any launch)."""
    cfg = _residual_config(40, 3)
    tm = build_model(copy.deepcopy(cfg), dtype=BF16)
    load_state(tm, params_from_jax(_variables(cfg, 54)))
    block = [m for m in tm.modules() if isinstance(m, TL.ResidualBlock)][0]
    assert not block.conv1.fused(BF16, False)
    bases, lengths = _bases(np.random.default_rng(55), tm.crop_nt, "masked")
    with torch.inference_mode():
        out = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    assert torch.isfinite(out["prediction"].float()).all()


def _fasta(tmp_path: Path) -> Path:
    rng = np.random.default_rng(56)
    path = tmp_path / "two.fasta"
    path.write_text("".join(
        f">c{i}\n{''.join(rng.choice(list('ACGT'), size=n))}\n"
        for i, n in enumerate((1300, 900))))
    return path


def test_crop_length_warning_matches_jax(tmp_path, caplog):
    """The demo bundle (crop 500 nt, 165 codons) at ``--fsize 400``."""
    fasta = _fasta(tmp_path)
    common = dict(input_path=str(fasta), model_path=str(BUNDLED_DEMO_MODEL),
                  fsize=400, stride=400, precision="float32")
    want = ("runtime --fsize 400 yields 131 codon frames but the model was "
            "trained on 165 (500 nt); windows will be zero-masked past 400 "
            "nt — prefer --fsize 500")
    with caplog.at_level(logging.WARNING):
        jax_run_core(output_dir=str(tmp_path / "jax"), devices=1, **common)
    jax_msgs = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING and "--fsize" in r.getMessage()]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        run_core(output_dir=str(tmp_path / "torch"), device="cpu",
                 workers=1, **common)
    port_msgs = [r.getMessage() for r in caplog.records
                 if r.levelno == logging.WARNING
                 and "--fsize" in r.getMessage()]
    assert jax_msgs == port_msgs == [want]


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "jaeger_tpu_torch.cli", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_int8_without_bundle_is_a_usage_error(tmp_path):
    """Exit 2 and the message, for the demo bundle and for an ensemble of
    two demo bundles (``utils combine-models``)."""
    ens = tmp_path / "ens"
    made = _cli("utils", "combine-models", "-i", str(BUNDLED_DEMO_MODEL),
                "-i", str(BUNDLED_DEMO_MODEL), "-o", str(ens), "-c", "mean",
                "--device", "cpu")
    assert made.returncode == 0, made.stderr
    fasta = _fasta(tmp_path)
    for model, flag in ((BUNDLED_DEMO_MODEL, ["--int8"]),
                        (ens, ["--int8", "auto"])):
        res = _cli("predict", "-i", str(fasta), "-o", str(tmp_path / "out"),
                   "-m", str(model), *flag, "--device", "cpu")
        assert res.returncode == 2, (res.returncode, res.stderr)
        assert "error: no int8 bundle found for" in res.stderr
        assert "Traceback" not in res.stderr
