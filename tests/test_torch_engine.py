"""The port's reduction and inference engine against the JAX ones.

``contig_partials``: ``window_cls`` and the counts exactly, float sums
within 1e-6. The engine: the same WindowBatches through both engines
(the tiny dense-path config of tests/test_dense_path.py, whose weights
JAX initializes and ``params_from_jax`` carries across) must pick the
same program per batch and give the same outputs — per-window logits at
1e-5 relative (f32 sums in another order), per-contig statistics
exactly after their float16 rounding or within one float16 step, and
window classes exactly — including the split-mixed cases of
tests/test_engine_split.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.infer.engine import InferenceEngine as JaxEngine
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.ops.reduce import contig_partials as jax_partials
from jaeger_tpu_torch.infer.engine import InferenceEngine
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.ops.reduce import contig_partials

from tests.test_dense_path import CONFIG
from tests.test_engine_split import _mixed_windows, _window_batch


@pytest.mark.parametrize("with_rel", [True, False])
def test_contig_partials_match_jax(rng, with_rel):
    b, c, n_seg = 64, 6, 64
    logits = rng.normal(size=(b, c)).astype(np.float32) * 2
    logits[5] = logits[5, 0]                      # an argmax tie
    seg = np.sort(rng.integers(0, 9, size=b)).astype(np.int32)
    valid = rng.random(b) > 0.2
    rel = rng.normal(size=(b, 1)).astype(np.float32)
    want = jax_partials(jnp.asarray(logits), jnp.asarray(seg),
                        jnp.asarray(valid), num_segments=n_seg,
                        reliability=jnp.asarray(rel) if with_rel else None)
    got = contig_partials(torch.from_numpy(logits), torch.from_numpy(seg),
                          torch.from_numpy(valid), n_seg,
                          reliability=(torch.from_numpy(rel) if with_rel
                                       else None))
    assert set(got) == set(want)
    for key in want:
        a = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == a.shape, key
        if key in ("window_cls", "count", "cls_counts", "energy_count",
                   "rel_above", "rel_count"):
            assert g.dtype == a.dtype, key
            np.testing.assert_array_equal(g, a, err_msg=key)
        else:
            np.testing.assert_allclose(g, a, rtol=1e-6, atol=1e-6,
                                       err_msg=key)


@pytest.fixture(scope="module")
def engines_model():
    b = ModelBuilder(CONFIG)
    model, variables = b.init()
    tmodel = build_model(CONFIG)
    load_state(tmodel, params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return b.crop[1], model, variables, tmodel


def _engines(engines_model, bs, **kw):
    _, model, variables, tmodel = engines_model
    return (JaxEngine(model, variables, batch_size=bs, **kw),
            InferenceEngine(tmodel, batch_size=bs, device="cpu", **kw))


def _bounded_windows(rng, crop_nt, n):
    """Every row has one interior N: too many for the split bucket, all
    qualifying for a bounded cut."""
    cap = crop_nt + 20
    bases = rng.integers(0, 4, size=(n, cap)).astype(np.uint8)
    bases[np.arange(n), rng.integers(20, crop_nt - 20, size=n)] = 4
    return bases, np.full(n, cap, np.int32)


@pytest.mark.parametrize("case", ["split", "bounded", "masked", "dense"])
def test_engine_windows_match_jax(engines_model, rng, case):
    crop_nt = engines_model[0]
    if case == "split":
        bases, lengths = _mixed_windows(rng, crop_nt, n=64)
    elif case == "bounded":
        bases, lengths = _bounded_windows(rng, crop_nt, 40)
    elif case == "masked":
        bases, lengths = _mixed_windows(rng, crop_nt, n=40,
                                        masked_positions=(3, 17, 39))
        lengths[::2] = crop_nt // 2              # short windows everywhere
    else:
        bases = rng.integers(0, 4, size=(40, crop_nt)).astype(np.uint8)
        lengths = np.full(40, crop_nt, np.int32)
    jeng, teng = _engines(engines_model, 32)
    for i in range(0, len(bases), 32):
        b, ln = bases[i: i + 32], lengths[i: i + 32]
        jp, tp = jeng._plan_batch(b, ln, len(b)), teng._plan_batch(
            b, ln, len(b))
        assert jp[0] == tp[0] and jp[2] == tp[2]
        assert (jp[1] is None) == (tp[1] is None)
        if jp[1] is not None:
            np.testing.assert_array_equal(jp[1][0], tp[1][0])
            assert jp[1][1] == tp[1][1]
    want = jeng.predict_windows(bases, lengths)
    got = teng.predict_windows(bases, lengths)
    programs = {p for _, p in teng.program_counts}
    expect = {"split": {"dense", "masked"}, "dense": {"dense"}}.get(case)
    if expect is not None:
        assert programs == expect
    elif case == "masked":
        # the short windows force the full masked program; the plan per
        # batch equals the JAX engine's (checked above)
        assert "masked" in programs
    else:
        assert all(isinstance(p, tuple) and p[0] == "bounded"
                   for p in programs), programs
    assert set(got) == set(want)
    for key in want:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=key)


@pytest.mark.parametrize("split_mixed", [True, False])
def test_engine_reduced_matches_jax(engines_model, rng, split_mixed):
    """Device-reduced statistics on the test_engine_split batch: masked
    windows at batch boundaries and in the padded tail."""
    crop_nt = engines_model[0]
    bases, lengths = _mixed_windows(
        rng, crop_nt, n=50, masked_positions=(0, 15, 16, 31, 49))
    batch = _window_batch(bases, lengths, np.repeat(np.arange(5), 10))
    jeng, teng = _engines(engines_model, 16, split_mixed=split_mixed)
    want, _ = jeng.predict_batches_reduced([batch], num_classes=3)
    got, kept = teng.predict_batches_reduced([batch], num_classes=3)
    assert kept == [batch]
    assert got.keys() == want.keys()
    if split_mixed:
        assert any(rows < 16 for rows, _ in teng.program_counts)
    for g in want:
        a, r = got[g], want[g]
        assert a["n_windows"] == r["n_windows"]
        np.testing.assert_array_equal(a["frag_pred"], r["frag_pred"])
        np.testing.assert_array_equal(a["cls_counts"], r["cls_counts"])
        for key in ("pred_sum", "pred_var", "entropy", "energy",
                    "reliability"):
            av = np.asarray(a[key], np.float64)
            rv = np.asarray(r[key], np.float64)
            # float16 results: equal, or one float16 step apart
            step = np.spacing(np.abs(rv).astype(np.float16)).astype(
                np.float64)
            assert np.all(np.abs(av - rv) <= step + 1e-12), (g, key)


def test_engine_batches_full_path_matches_jax(engines_model, rng):
    crop_nt = engines_model[0]
    bases, lengths = _mixed_windows(rng, crop_nt, n=40,
                                    masked_positions=(3, 17, 39))
    batch = _window_batch(bases, lengths, np.repeat(np.arange(4), 10))
    jeng, teng = _engines(engines_model, 16, output_keys=("prediction",))
    want, _ = jeng.predict_batches([batch, batch])
    got, kept = teng.predict_batches([batch, batch])
    assert list(got) == ["prediction"] and len(kept) == 2
    np.testing.assert_allclose(got["prediction"], want["prediction"],
                               rtol=1e-5, atol=1e-5)
