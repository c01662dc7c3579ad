"""The legacy model family in the port against jaeger_tpu, on the CPU.

* ``encode_amino_windows`` and ``encode_murphy_windows`` equal JAX's
  tokens exactly, on windows with soft-masked bases, N runs and short
  lengths;
* ``WResModel`` (the shipped default weights), ``ExperimentalModel`` (2
  residual blocks), ``LSTMModel`` and ``Vitra`` (1 transformer layer), with
  seeded weights carried across by ``params_from_jax``, compute
  JAX's ``model.apply`` at f32: logits and embeddings to 1e-5 of each
  output's scale;
* ``convert_wres_h5`` on the JAX package's ``WRes_1024.h5`` gives exactly
  JAX's leaves; ``build_default_bundle`` into a temporary directory
  reproduces the shipped ``jaeger_tpu_torch/data/models/default`` byte for
  byte; the shipped OOD classifier's ``predict_proba`` equals the
  scikit-learn pickle's to 1e-12 on the default model's embeddings of
  ``test_contigs.fasta``;
* ``convert_experimental_h5`` on a small Keras ``.h5`` written with
  ``h5py`` (Keras 3's layout, and TF-Keras groups with the layer names of
  ``tests/test_legacy_v2.py``'s restatement) gives JAX's tree, and the
  port's forward on it JAX's;
* ``predict -m default`` and ``predict-legacy`` through the port's CLI on
  ``test_contigs.fasta`` write TSVs byte-identical to JAX's ``run_core``
  with the same options.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.commands import predict_legacy as jpl
from jaeger_tpu.models import legacy as JLeg
from jaeger_tpu.models import legacy_convert as jlc
from jaeger_tpu_torch import cli
from jaeger_tpu_torch.commands import predict_legacy as tpl
from jaeger_tpu_torch.models import legacy as TLeg
from jaeger_tpu_torch.models import legacy_convert as tlc
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.postprocess import legacy_collect as lc

ROOT = Path(__file__).resolve().parents[1]
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
JAX_DEFAULT = ROOT / "jaeger_tpu" / "data" / "models" / "default"
TOL = 1e-5


def _bases(rng, n, crop):
    """Base IDs 0-3, N (4) runs and soft-masked bases (5-8); lengths from
    full to a few codons and 0."""
    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    bases[0, 10:40] = 4
    bases[1] = rng.integers(0, 9, size=crop)
    bases[2, crop // 2:] += 5
    lengths = np.full(n, crop, np.int32)
    lengths[3] = crop // 3
    lengths[4] = 7
    lengths[5] = 0
    return bases, lengths


@pytest.mark.parametrize("crop", [200, 2048])
@pytest.mark.parametrize("which", ["amino", "murphy"])
def test_encoders_equal_jax(crop, which):
    bases, lengths = _bases(np.random.default_rng(crop), 8, crop)
    jfn = getattr(JLeg, f"encode_{which}_windows")
    tfn = getattr(TLeg, f"encode_{which}_windows")
    want = np.asarray(jfn(jnp.asarray(bases), jnp.asarray(lengths), crop))
    got = tfn(torch.from_numpy(bases), torch.from_numpy(lengths), crop)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0 and (want == 0).any()


def _randomize(variables, seed):
    """Random biases, BN scales and moving statistics (kernels kept), so
    every leaf matters."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name in ("kernel", "embedding", "pos_embedding"):
            return x
        if name in ("scale", "var"):
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _tokens(seed, n=3, length=48, vocab=22):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(n, 6, length)).astype(np.int32)
    toks[0, :, 30:] = 0
    toks[1, 2, ::5] = 0
    return toks


def _wres_variables():
    return jlc.convert_wres_h5(JAX_DEFAULT / "WRes_1024.h5")


# name -> (JAX module, port module, variables or None for a seeded init)
MODELS = {
    "wres": (lambda: JLeg.WResModel(dropout_active=False),
             lambda: TLeg.WResModel(), _wres_variables),
    "experimental": (lambda: JLeg.ExperimentalModel(num_res_blocks=2),
                     lambda: TLeg.ExperimentalModel(num_res_blocks=2), None),
    "lstm": (lambda: JLeg.LSTMModel(), lambda: TLeg.LSTMModel(), None),
    "vitra": (lambda: JLeg.Vitra(transformer_layers=1),
              lambda: TLeg.Vitra(num_patches=12, transformer_layers=1),
              None),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_equals_jax(name):
    jmod, tmod, make_vars = MODELS[name]
    jm = jmod()
    toks = _tokens(7, vocab=11 if name == "experimental" else 22)
    if make_vars is None:
        variables = _randomize(jm.init(jax.random.PRNGKey(3),
                                       jnp.asarray(toks)), 5)
    else:
        variables = make_vars()
    want = jm.apply(variables, jnp.asarray(toks), train=False)
    tm = tmod()
    load_state(tm, params_from_jax(variables))
    tm.eval()
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], f"{name} {k}")
    # the carry-over is a rename: the tree written back is JAX's
    back = TLeg.variables_from_state(tm)
    flat_w = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_g)
    for p, v in flat_w:
        np.testing.assert_array_equal(flat_g[p], np.asarray(v))


def test_convert_wres_h5_equals_jax():
    want = jlc.convert_wres_h5(JAX_DEFAULT / "WRes_1024.h5")
    got = tlc.convert_wres_h5(JAX_DEFAULT / "WRes_1024.h5")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert len(flat_w) == 79
    assert sum(np.asarray(v).size for _, v in flat_w) == 947036
    for (p, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == np.asarray(w).dtype, p
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))


def test_build_default_bundle_reproduces_shipped_files(tmp_path):
    out = tlc.build_default_bundle(
        JAX_DEFAULT / "WRes_1024.h5",
        JAX_DEFAULT / "LR_ood_4_class_default.pkl", tmp_path / "default")
    shipped = tpl.DEFAULT_MODEL_DIR
    names = sorted(p.name for p in shipped.iterdir())
    assert names == sorted(p.name for p in out.iterdir()) == sorted(
        [tlc.PARAMS_FILE, tlc.OOD_FILE, *tlc.STATS_FILES])
    for name in names:
        assert (out / name).read_bytes() == (shipped / name).read_bytes(), \
            name


@pytest.fixture(scope="module")
def default_embeddings():
    """The default model's embeddings of every window of the test contigs
    (fsize 2048), as ``run_core`` computes them."""
    from jaeger_tpu_torch.seqops.windows import window_batches

    model, encode = tpl.load_legacy_model(tpl.DEFAULT_MODEL_DIR,
                                          device="cpu")
    embs = []
    with torch.inference_mode():
        for wb in window_batches(str(FASTA), fragsize=2048, stride=2048):
            toks = encode(torch.from_numpy(wb.bases),
                          torch.from_numpy(wb.length), 2048)
            embs.append(model(toks)["embedding"].numpy())
    return np.concatenate(embs)


def test_ood_head_equals_sklearn(default_embeddings):
    import joblib

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf = joblib.load(JAX_DEFAULT / "LR_ood_4_class_default.pkl")
    ours = lc.CalibratedLogistic.load(tpl.DEFAULT_MODEL_DIR / tlc.OOD_FILE)
    mean = np.load(tpl.DEFAULT_MODEL_DIR / "batch_means.npy")
    std = np.load(tpl.DEFAULT_MODEL_DIR / "batch_std.npy")
    x = (default_embeddings - mean) / std
    x = x / np.linalg.norm(x, 2, axis=1).reshape(-1, 1)
    assert x.shape == (100, 128)
    want = clf.predict_proba(x)
    got = ours.predict_proba(x)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    params = {"type": "sklearn", "batch_mean": mean, "batch_std": std}
    np.testing.assert_allclose(
        lc.ood_predict_default(default_embeddings, dict(params, model=ours))[0],
        lc.ood_predict_default(default_embeddings, dict(params, model=clf))[0],
        rtol=0, atol=1e-12)


def _write_keras_h5(path: Path, variables: dict, order, layout: str) -> None:
    """``variables`` of JAX's ExperimentalModel as a Keras ``.h5``:
    ``"keras3"`` is Keras 3's object-tree layout (``layers/<class>[_<n>]/
    vars/<i>``, the counter per class in the order the layers were made,
    ``order``: the order of flax's tree); ``"layer_names"`` the TF-Keras
    layout (``<layer>/<layer>/<weight>:0``) with the reference's layer
    names (``tests/test_legacy_v2.py``)."""
    import h5py

    params, stats = variables["params"], variables["batch_stats"]
    counters: dict[str, int] = {}
    with h5py.File(path, "w") as f:
        for name in order:
            p = params[name]
            if "kernel" in p:
                kind = "conv1d" if p["kernel"].ndim == 3 else "dense"
                weights = {"kernel": p["kernel"], "bias": p["bias"]}
            else:
                kind = "batch_normalization"
                weights = {"gamma": p["scale"], "beta": p["bias"],
                           "moving_mean": stats[name]["mean"],
                           "moving_variance": stats[name]["var"]}
            if layout == "keras3":
                n = counters.get(kind, 0)
                counters[kind] = n + 1
                g = f.create_group(
                    f"layers/{kind}{f'_{n}' if n else ''}/vars")
                for i, value in enumerate(weights.values()):
                    g.create_dataset(str(i), data=np.asarray(value))
            else:
                g = f.create_group(name).create_group(name)
                for key, value in weights.items():
                    g.create_dataset(f"{key}:0", data=np.asarray(value))


@pytest.mark.parametrize("layout", ["keras3", "layer_names"])
def test_convert_experimental_h5_equals_jax(tmp_path, layout):
    """Both packages' converters give the same tree, and the port's forward
    on it JAX's. In Keras 3's layout the matcher puts every weight back
    where it came from; with TF-Keras layer names its tie-break between
    the same-shaped residual convs follows the digits of the names, not
    the order the layers were made, in both packages alike."""
    n_blocks = 2
    jm = JLeg.ExperimentalModel(num_res_blocks=n_blocks)
    toks = _tokens(9, length=40, vocab=11)
    init = jm.init(jax.random.PRNGKey(4), jnp.asarray(toks))
    variables = _randomize(init, 6)
    h5 = tmp_path / "experimental_1.h5"
    _write_keras_h5(h5, variables, list(init["params"]), layout)
    want = jlc.convert_experimental_h5(h5, num_res_blocks=n_blocks)
    got = tlc.convert_experimental_h5(h5, num_res_blocks=n_blocks)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    if layout == "keras3":
        flat_g = dict(flat_g)
        for p, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
            np.testing.assert_array_equal(flat_g[p], np.asarray(v),
                                          err_msg=str(p))
    tm = TLeg.ExperimentalModel(num_res_blocks=n_blocks).eval()
    load_state(tm, params_from_jax(got))
    ref = jm.apply(want, jnp.asarray(toks), train=False)
    with torch.inference_mode():
        out = tm(torch.from_numpy(toks))
    for k in ref:
        _close(out[k], ref[k], f"experimental {k}")


@pytest.mark.parametrize("entry", ["predict", "predict-legacy"])
def test_run_core_tsv_byte_identical_to_jax(tmp_path, entry):
    """``predict -m default`` (``predict``'s defaults: fsize 2000, stride
    1500, batch 96, --rc 0.1) and ``predict-legacy`` (fsize 2048, stride
    2048, batch 128, --rc 0.5) through the port's CLI, against JAX's
    ``run_core`` with the options its CLI passes."""
    out = tmp_path / "torch"
    if entry == "predict":
        kw = dict(fsize=2000, stride=1500, batch=96, reliability_cutoff=0.1,
                  phage_score=3.0)
        cli.main(["predict", "-i", str(FASTA), "-o", str(out), "-m",
                  "default", "--device", "cpu", "--workers", "1"])
    else:
        kw = {}
        cli.main(["predict-legacy", "-i", str(FASTA), "-o", str(out),
                  "--device", "cpu", "--workers", "1"])
    want = jpl.run_core(str(FASTA), str(tmp_path / "jax"),
                        model_name="default", workers=1, **kw)
    got = out / want.name
    assert want.name == "test_contigs_default_jaeger.tsv"
    assert got.read_bytes() == want.read_bytes()
    phages = "test_contigs_default_phages_jaeger.tsv"
    assert (out / phages).read_bytes() == (
        tmp_path / "jax" / phages).read_bytes()
    assert want.read_bytes().count(b"\n") == 10
