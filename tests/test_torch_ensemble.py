"""Ensemble bundles in the port against jaeger_tpu, on the CPU.

* ``EnsembleModel``'s combination against JAX's on stub members whose
  outputs are exact in f32 (quarters): every method, keys common to all
  members only, majority-vote ties (lowest class) and mv's masked mean
  (a member whose logit at the majority class is 0 is not counted);
* an ensemble of two bundles (the demo model and a seeded model of the
  demo's config) loaded by ``load_ensemble`` on both sides: the forward in
  the dense and masked programs, f32, to 1e-5 of each output's scale;
* ``combine_models_core`` and ``utils combine-models`` write JAX's
  ``ensemble.yaml`` byte for byte;
* ``run_core`` with the ensemble bundle, f32: the TSV byte-identical to
  JAX ``run_core``'s (JAX with ``devices=1``) for mv, sum and mean; the
  engine plans no bounded program for an ensemble (its members' configs
  have cuts), as the JAX engine does not;
* ``run_core`` with ``int8`` on an ensemble raises where JAX's CLI raises
  (the int8 bundle is resolved first and an ensemble has none).
"""

import shutil

import click
import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from jaeger_tpu.cli import _resolve_int8_bundle as jax_resolve_int8_bundle
from jaeger_tpu.commands.predict import run_core as jax_run_core
from jaeger_tpu.models import ensemble as jens
from jaeger_tpu_torch import cli
from jaeger_tpu_torch.commands.predict import run_core
from jaeger_tpu_torch.infer.engine import InferenceEngine
from jaeger_tpu_torch.models import ensemble as tens
from jaeger_tpu_torch.models.artifacts import init_params, save_model
from jaeger_tpu_torch.models.builder import mask_cut_plan
from jaeger_tpu_torch.utils.config import load_model_config

FASTA = "jaeger_tpu/data/test/test_contigs.fasta"
DEMO = "jaeger_tpu/data/models/demo"
TOL = 1e-5


class _JaxStub:
    def __init__(self, out):
        self.out = out

    def apply(self, variables, inputs, train=False, **kwargs):
        return {k: jnp.asarray(v) for k, v in self.out.items()}


class _TorchStub(nn.Module):
    def __init__(self, out):
        super().__init__()
        self.out = out

    def forward(self, *args, **kwargs):
        return {k: torch.from_numpy(v) for k, v in self.out.items()}


def _stub_outputs():
    """Three members, four examples, three classes, in quarters: example 0
    a majority for class 1 where member 2's logit is exactly 0; example 1
    a three-way tie (class 0 wins; member 1's logit there is 0); example 2
    two votes for class 2; example 3 all three on class 0. Member 0 has an
    extra key."""
    rng = np.random.default_rng(0)
    preds = [np.array([[0.5, 2.0, -1.0], [3.0, 0.25, 0.0],
                       [0.0, 1.0, 1.5], [2.0, -0.5, 0.75]], np.float32),
             np.array([[-0.25, 1.5, 0.5], [0.0, 2.5, -1.0],
                       [-1.0, 0.5, 2.25], [1.25, 1.0, 0.5]], np.float32),
             np.array([[2.0, 0.0, 1.75], [0.5, -0.5, 1.0],
                       [1.0, 0.75, -0.25], [0.5, 0.25, -1.5]], np.float32)]
    outs = []
    for i, p in enumerate(preds):
        o = {"prediction": p,
             "reliability": (rng.integers(-8, 8, (4, 1)) / 4).astype(
                 np.float32)}
        if i == 0:
            o["embedding"] = np.ones((4, 5), np.float32)
        outs.append(o)
    return outs


@pytest.mark.parametrize("method", list(tens.METHODS))
def test_ensemble_combines_like_jax(method):
    outs = _stub_outputs()
    want = jens.EnsembleModel([_JaxStub(o) for o in outs], method).apply(
        {"members": [None] * 3}, {}, train=False)
    got = tens.EnsembleModel([_TorchStub(o) for o in outs], method)(None)
    assert set(got) == set(want) == {"prediction", "reliability"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{method} {k}")
    if method == "mv":
        pred = got["prediction"].numpy()
        # example 0: class 1 by two votes to one, the mean of the two
        # non-zero logits there (member 2's is 0); example 1: a three-way
        # tie goes to class 0, where member 1's logit is 0
        assert pred[0].tolist() == [0.0, 1.75, 0.0]
        assert pred[1].tolist() == [1.75, 0.0, 0.0]
    with pytest.raises(ValueError, match="unknown combination"):
        tens.EnsembleModel([_TorchStub(outs[0])], "median")


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """The demo bundle and a model of the demo's config with seeded
    weights (3 classes, crop 500 nt)."""
    tmp = tmp_path_factory.mktemp("ensemble")
    demo = tmp / "demo"
    shutil.copytree(DEMO, demo)
    cfg = load_model_config(demo / "project.yaml")
    other = save_model(init_params(cfg, torch.Generator().manual_seed(7)),
                       cfg, tmp / "seeded")
    shutil.copy(demo / "classes.yaml", other / "classes.yaml")
    return tmp, [str(demo), str(other)]


def _ensemble(members, method: str):
    tmp, paths = members
    out = tmp / f"ens_{method}"
    if not out.exists():
        tens.combine_models_core(paths, str(out), method, device="cpu")
    return out


@pytest.mark.parametrize("method", ["mv", "sum", "mean"])
def test_ensemble_of_bundles_matches_jax(members, method):
    ens = _ensemble(members, method)
    jm, jvars, jcfg, jcls = jens.load_ensemble(ens, dtype=jnp.float32)
    model, cfg, classes = tens.load_ensemble(ens, device="cpu")
    assert cfg == jcfg and classes == jcls
    assert model.crop_nt == jm.crop_nt == 500
    assert model.masking_enabled == jm.masking_enabled
    rng = np.random.default_rng(3)
    bases = rng.integers(0, 9, size=(8, 500)).astype(np.uint8)
    bases[:4] %= 4
    lengths = np.array([500] * 6 + [300, 120], np.int32)
    for kw, rows in (({"assume_dense": True}, slice(0, 4)), ({}, slice(None))):
        b, ln = bases[rows], lengths[rows]
        want = jm.apply(jvars, {"bases": jnp.asarray(b),
                                "lengths": jnp.asarray(ln)}, **kw)
        with torch.inference_mode():
            got = model(torch.from_numpy(b), torch.from_numpy(ln), **kw)
        assert set(got) == set(want)
        for k in want:
            a = np.asarray(want[k], np.float32)
            scale = max(float(np.abs(a).max()), 1e-6)
            np.testing.assert_allclose(got[k].numpy(), a, rtol=TOL,
                                       atol=TOL * scale,
                                       err_msg=f"{method} {kw} {k}")


def test_combine_models_writes_jax_yaml(members, tmp_path):
    _, paths = members
    jens.combine_models_core(paths, str(tmp_path / "jax"), "mv")
    tens.combine_models_core(paths, str(tmp_path / "core"), "mv",
                             device="cpu")
    cli.main(["utils", "combine-models", "-i", paths[0], paths[1], "-o",
              str(tmp_path / "cli"), "-c", "MV", "--device", "cpu"])
    want = (tmp_path / "jax" / "ensemble.yaml").read_bytes()
    assert b"method: mv" in want
    for out in ("core", "cli"):
        assert (tmp_path / out / "ensemble.yaml").read_bytes() == want, out
    assert tens.is_ensemble(tmp_path / "cli")
    assert not tens.is_ensemble(paths[0])


@pytest.mark.parametrize("method", ["mv", "sum", "mean"])
def test_run_core_ensemble_tsv_matches_jax(members, tmp_path, method):
    ens = _ensemble(members, method)
    common = dict(input_path=FASTA, model_path=str(ens), fsize=2000,
                  stride=1500, batch=96, precision="float32",
                  reliability_cutoff=0.1, phage_score=3.0)
    want = jax_run_core(output_dir=str(tmp_path / "jax"), devices=1,
                        **common)
    got = run_core(output_dir=str(tmp_path / "torch"), device="cpu",
                   workers=1, **common)
    assert want.read_bytes().count(b"\n") == 10
    assert got.read_bytes() == want.read_bytes()


def test_engine_plans_no_bounded_program_for_ensemble(members):
    _, paths = members
    cfg = load_model_config(paths[0] + "/project.yaml")
    assert mask_cut_plan(cfg["model"]["representation_learner"])
    model, _, _ = tens.load_ensemble(_ensemble(members, "mean"),
                                     device="cpu")
    engine = InferenceEngine(model, batch_size=8, device="cpu")
    assert engine._plans == []
    bases = np.random.default_rng(5).integers(0, 4, size=(8, 500)).astype(
        np.uint8)
    bases[:, 200] = 4                        # one interior N per row
    engine.predict_windows(bases, np.full(8, 500, np.int32))
    assert set(engine.program_counts) == {(8, "masked")}


@pytest.mark.parametrize("flag", [{"int8": "full"}, {"int8": "auto"},
                                  {"quantized": "full_int8"}])
def test_run_core_int8_on_ensemble_raises_as_jax(members, tmp_path, flag):
    ens = str(_ensemble(members, "mean"))
    with pytest.raises(click.UsageError, match="no int8 bundle found"):
        jax_resolve_int8_bundle(ens)
    with pytest.raises(FileNotFoundError, match="no int8 bundle found"):
        run_core(FASTA, str(tmp_path), ens, device="cpu", **flag)
