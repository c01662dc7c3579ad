"""The layer-zoo templates in the port against jaeger_tpu, on the CPU.

Four templates of ``train_config/`` at narrow widths (16 channels, one
residual block, short crops, dropout 0 so that no random numbers need
sharing): the variable-length template (dilation-3 residual convs, max
pooling, three NMD taps merged by concat, runtime crops of NPZ tokens), the
dvf template (nucleotide input, a shared-weight branch per strand, a
branched classifier merged by averaging), the cross-frame template and the
axial template (attention over frames and along the length, masked batch
norms with NMD). Weights cross with ``params_from_jax``; inputs are made
with numpy from a seed. Covered:

* the forward in every program the engine picks (dense, masked and each
  bounded cut), f32, to 1e-5 of each output's scale;
* one train step per program (loss, every gradient leaf, the batch
  statistics, the parameters after the step) with the tolerances of
  ``tests/test_torch_train.py``: gradients to 5e-5 of each leaf's scale;
  the variable-length template also on an NPZ token batch, the
  cross-frame template's reliability branch with frozen prefixes;
* ``predict`` (``run_core``) on ``test_contigs.fasta`` at f32: the TSV
  byte-identical to JAX's for a translated and a nucleotide template;
* ``train --device cpu`` end to end on each template, then ``predict``
  on what it wrote; JAX loads the bundle and computes the same outputs;
* a BiLSTM and a Hyena block inserted into the cross-frame template, and
  the Hyena template at its own widths, build and compute JAX's forward
  (``tests/test_torch_hyena.py`` and ``tests/test_torch_bilstm.py`` hold
  the layers and the Hyena template in every program);
* int8 execution of the dvf and cross-frame templates is refused, naming
  ROADMAP.md queue 1, item 10.
"""

import copy

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from jaeger_tpu.models import builder as jbuilder
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.train import loop as jloop
from jaeger_tpu.train import optimizers as jopt
from jaeger_tpu.utils.config import load_model_config as jax_load_config
from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                               params_from_jax, save_model)
from jaeger_tpu_torch.models.builder import build_model, mask_cut_plan
from jaeger_tpu_torch.train import loop as tloop
from jaeger_tpu_torch.train import optimizers as topt

FASTA = "jaeger_tpu/data/test/test_contigs.fasta"
TOL = 1e-5
GRAD_TOL = 5e-5
TEMPLATES = {
    "variable_length": "train_config/fragment_6class_variable_length.yaml",
    "dvf": "train_config/fragment_3class_500bp_dvf.yaml",
    "crossframe": "train_config/fragment_3class_500bp_crossframe.yaml",
    "axial": "train_config/fragment_3class_500bp_axial.yaml",
}


def _narrow_layers(layers):
    for entry in layers:
        c = entry.setdefault("config", {}) or {}
        entry["config"] = c
        if "filters" in c:
            c["filters"] = 16
        if "block_size" in c:
            c["block_size"] = 1
        if "embed_dim" in c:
            c.update(embed_dim=16, feed_forward_dim=32)
        if "rate" in c:
            c["rate"] = 0.0
        if "dropout_rate" in c:
            c["dropout_rate"] = 0.0
        if entry["name"] == "dense" and c.get("units", 0) > 16:
            c["units"] = 12


def narrow(name: str) -> dict:
    """The template cut to 16 channels, one block per residual stack, a
    40-codon (125 nt) or 100 nt crop and no dropout."""
    cfg = jax_load_config(TEMPLATES[name])
    m = cfg["model"]
    for section in ("representation_learner", "classifier",
                    "reliability_model"):
        sec = m.get(section) or {}
        _narrow_layers(sec.get("hidden_layers", []))
        _narrow_layers((sec.get("branch") or {}).get("hidden_layers", []))
    if m["embedding"].get("embedding_size"):
        m["embedding"]["embedding_size"] = 16
    sp = m["string_processor"]
    if sp.get("crop_sizes"):
        sp.update(crop_sizes=[20, 30, 40], validation_crop_sizes=[40])
    elif m["embedding"].get("input_type") == "nucleotide":
        sp["crop_size"] = 100
    else:
        sp["crop_size"] = 40
    return cfg


def _randomize(variables, seed):
    """Random norms, biases and moving statistics, so every leaf matters."""
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


def _variables(cfg, seed):
    """Seeded flax variables for ``cfg`` (the port's ``init_params``; the
    tree equals JAX's, ``test_param_tree_equals_jax`` pins it)."""
    state = init_params(copy.deepcopy(cfg), torch.Generator().manual_seed(
        seed))
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *scopes, leaf = key.split(".")
        coll = ("batch_stats" if leaf in ("moving_mean", "moving_variance")
                else "params")
        node = tree[coll]
        for sc in scopes:
            node = node.setdefault(sc, {})
        node[leaf] = t.numpy()
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return _randomize(tree, seed)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def setups():
    """template -> (narrow config, jax model, randomized variables)."""
    out = {}
    for i, name in enumerate(TEMPLATES):
        cfg = narrow(name)
        out[name] = (cfg, ModelBuilder(copy.deepcopy(cfg)).build(),
                     _variables(cfg, 3 + i))
    return out


def _close(got, want, what, tol=TOL, overall=None):
    """``overall``: the largest gradient of any leaf; a leaf far below it
    holds rounding noise around an exact zero (tests/test_torch_train.py)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    if overall is not None and scale < 1e-4 * overall:
        scale = overall
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _bases(rng, crop, program, n=6):
    """Dense windows, one interior N per row (bounded), or N runs, a short
    row and soft-masked bases (masked)."""
    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.full(n, crop, np.int32)
    if program == "bounded":
        bases[np.arange(n), rng.integers(20, crop - 20, size=n)] = 4
    elif program == "masked":
        bases[0, 20:60] = 4
        lengths[1] = crop // 2
        bases[2, : crop // 3] = rng.integers(0, 9, size=crop // 3)
        lengths[3] = 0
    return bases, lengths


def _programs(cfg):
    """(name, JAX/port keyword arguments) of every program of ``cfg``."""
    progs = [("dense", {"assume_dense": True}), ("masked", {})]
    plans = mask_cut_plan(cfg["model"]["representation_learner"]) or []
    progs += [(f"bounded{i}", {"mask_layers": cut})
              for i, (cut, _, _) in enumerate(plans)]
    return progs


FORWARD_CASES = [(t, p) for t in TEMPLATES
                 for p, _ in _programs(narrow(t))]


def test_programs_per_template():
    """The engine's programs: the variable-length template has both cuts
    of its dilated first stack; branches and attention have none."""
    assert [c for c in FORWARD_CASES if c[0] == "variable_length"] == [
        ("variable_length", p)
        for p in ("dense", "masked", "bounded0", "bounded1")]
    for t in ("dvf", "crossframe", "axial"):
        assert [p for n, p in FORWARD_CASES if n == t] == ["dense", "masked"]


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_mask_cut_plan_matches_jax(name):
    """The bounded program's cuts for the template at its own widths and
    cut narrow: the port's plan is JAX's (attention and branches: none)."""
    for cfg in (jax_load_config(TEMPLATES[name]), narrow(name)):
        rep = cfg["model"]["representation_learner"]
        assert mask_cut_plan(rep) == jbuilder.mask_cut_plan(rep)


def test_param_tree_equals_jax(setups):
    """The port's parameter and statistics names and shapes are JAX's:
    params_from_jax is a rename for every template."""
    for name, (cfg, _, _) in setups.items():
        jv = jax.eval_shape(
            lambda: ModelBuilder(copy.deepcopy(cfg)).init(batch=1)[1])
        want = {"/".join(str(p.key) for p in path[1:]): tuple(v.shape)
                for path, v in jax.tree_util.tree_leaves_with_path(jv)}
        got = {k.replace(".", "/"): tuple(v.shape) for k, v in
               build_model(copy.deepcopy(cfg)).state_dict().items()}
        assert got == want, name


@pytest.mark.parametrize("name,program", FORWARD_CASES)
def test_forward_matches_jax(setups, name, program):
    cfg, model, variables = setups[name]
    kw = dict(_programs(cfg))[program]
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    rng = np.random.default_rng(7)
    bases, lengths = _bases(rng, tm.crop_nt,
                            "bounded" if program.startswith("bounded")
                            else program)
    want = model.apply(variables, {"bases": jnp.asarray(bases),
                                   "lengths": jnp.asarray(lengths)}, **kw)
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths), **kw)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], f"{name} {program} {k}")


def _capture():
    """An optax stage that passes the gradients on and keeps them as its
    state, so that one jitted JAX step also returns its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _check_step(cfg, model, variables, batch, common, lr):
    """One JAX step and one port step on ``batch``: loss, gradients,
    batch statistics, parameters after the optimizer."""
    t = cfg["training"]
    tx = jopt.make_optimizer(t["optimizer"], t["optimizer_params"])
    state = jloop.TrainState.create(variables, optax.chain(_capture(), tx))
    step = jax.jit(jloop.make_train_step(model, jloop.StepConfig(**common)))
    new_state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0))
    jg = _flat(new_state.opt_state[0])

    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    tstate = tloop.TrainState.create(tm, topt.make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    tstate, tmet = tloop.make_train_step(tm, tloop.StepConfig(**common))(
        tstate, tloop.to_device(batch, "cpu"))
    _close(float(tmet["loss"]), float(jm["loss"]), "loss")
    assert set(tstate.grads) == set(jg)
    overall = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        _close(tstate.grads[k].numpy(), jg[k], f"grad {k}", GRAD_TOL,
               overall)
    want_stats = (_flat(new_state.batch_stats) if new_state.batch_stats
                  else {})
    got_stats = {k.replace(".", "/"): v.numpy()
                 for k, v in tm.state_dict().items() if "moving" in k}
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], f"batch_stats {k}")
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in tm.named_parameters()}
    want = _flat(new_state.params)
    before = _flat(variables["params"])
    for k in want:
        g = np.abs(jg[k])
        big = (g > 1e-4) & (g > 1e-3 * float(g.max()))
        du_got, du_want = got[k] - before[k], want[k] - before[k]
        np.testing.assert_allclose(du_got[big], du_want[big], rtol=2e-3,
                                   atol=1e-7, err_msg=k)
        assert np.all(np.abs(du_got - du_want) <= 2 * lr + 1e-7), k
    return tstate


STEP_CASES = FORWARD_CASES[:3] + [("variable_length", "tokens")] + [
    c for c in FORWARD_CASES if c[0] != "variable_length"]


@pytest.mark.parametrize("name,program", STEP_CASES)
def test_train_step_matches_jax(tmp_path, setups, name, program):
    """One classifier step per program (dropout 0); the variable-length
    template also on a batch of NPZ tokens cropped by
    ``cropped_batches_from_npz`` (the masked program, as in ``train``)."""
    cfg, model, variables = setups[name]
    t = cfg["training"]
    n_classes = int(cfg["model"]["classifier_out_dim"])
    rng = np.random.default_rng(11)
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    if program == "tokens":
        from jaeger_tpu_torch.train import data as tdata

        path = _write_npz(rng, tmp_path / "train.npz", n=12, k=40)
        batch = next(tdata.cropped_batches_from_npz(
            path, batch_size=6, num_classes=n_classes,
            crop_sizes=[20, 30, 40], overlap=0.5, crop_mode="sample",
            seed=1))
        kw = {}
    else:
        kw = dict(_programs(cfg))[program]
        bases, lengths = _bases(rng, crop, "bounded"
                                if program.startswith("bounded")
                                else program)
        labels = np.eye(n_classes, dtype=np.float32)[
            rng.integers(0, n_classes, size=6)]
        batch = {"bases": bases, "lengths": lengths, "labels": labels}
    common = dict(loss_name=t["loss_classifier"],
                  loss_params=t["loss_params_classifier"],
                  heads=("prediction",), **kw)
    _check_step(cfg, model, variables, batch, common,
                float(t["optimizer_params"]["learning_rate"]))


def _write_npz(rng, path, n: int, k: int):
    """A converter NPZ of full-length token records (``translated`` (n, 6,
    k) int32, ``labels``) as ``train/data.py::load_npz_dataset`` reads
    it."""
    tokens = rng.integers(1, 65, size=(n, 6, k)).astype(np.int32)
    tokens[0, :, k // 2:] = 0
    np.savez(path, translated=tokens,
             labels=rng.integers(0, 6, size=n).astype(np.int64))
    return str(path)


def test_reliability_step_crossframe(setups):
    """The cross-frame template's reliability branch: rep and classifier
    frozen, the BN-embedded NMD taps' statistics update as JAX's."""
    cfg, model, variables = setups["crossframe"]
    rng = np.random.default_rng(3)
    bases, lengths = _bases(rng, build_model(copy.deepcopy(cfg)).crop_nt,
                            "masked")
    batch = {"bases": bases, "lengths": lengths,
             "labels": rng.integers(0, 2, size=(6, 1)).astype(np.float32)}
    common = dict(loss_name="binary_crossentropy",
                  loss_params={"from_logits": True},
                  output_key="reliability",
                  frozen_prefixes=("embedding", "rep", "classifier",
                                   "projection"),
                  heads=("reliability",))
    state = _check_step(cfg, model, variables, batch, common,
                        float(cfg["training"]["optimizer_params"][
                            "learning_rate"]))
    assert any(state.grads[k].any() for k in state.grads
               if k.startswith("reliability"))
    assert not any(state.grads[k].any() for k in state.grads
                   if k.startswith(("rep", "classifier", "embedding")))


def _bundle(tmp_path, setups, name):
    cfg, _, variables = setups[name]
    path = tmp_path / f"{name}_bundle"
    save_model(params_from_jax(variables), cfg, path)
    return path, build_model(copy.deepcopy(cfg)).crop_nt


@pytest.mark.parametrize("name", ["crossframe", "dvf"])
def test_predict_tsv_byte_identical_to_jax(tmp_path, setups, name):
    """``run_core`` at f32 with a bundle of the narrow template: the TSV
    equals JAX's byte for byte (windows of the model's crop)."""
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch.commands.predict import run_core

    bundle, crop = _bundle(tmp_path, setups, name)
    common = dict(input_path=FASTA, model_path=str(bundle), fsize=crop,
                  stride=crop, batch=512, precision="float32")
    want = jax_run_core(output_dir=str(tmp_path / "jax"), **common)
    got = run_core(output_dir=str(tmp_path / "torch"), device="cpu",
                   workers=1, **common)
    assert want.read_bytes().count(b"\n") == 10          # header + 9
    assert got.read_bytes() == want.read_bytes()


def _train_data(tmp_path, name, cfg):
    """Synthetic training data for ``cfg`` in the template's format: an
    NPZ of tokens for the variable-length template, ``label,sequence``
    CSVs otherwise."""
    rng = np.random.default_rng(5)
    m, t = cfg["model"], cfg["training"]
    n_classes = int(m["classifier_out_dim"])
    if name == "variable_length":
        train = _write_npz(rng, tmp_path / "train.npz", n=24, k=40)
        val = _write_npz(rng, tmp_path / "val.npz", n=12, k=40)
    else:
        crop = build_model(copy.deepcopy(cfg)).crop_nt
        acgt = np.array(list("ACGT"))
        for split, n in (("train", 48), ("val", 16)):
            rows = [f"{int(rng.integers(0, n_classes))},"
                    f"{''.join(acgt[rng.integers(0, 4, size=crop + 20)])}\n"
                    for _ in range(n)]
            (tmp_path / f"{split}.csv").write_text("".join(rows))
        train, val = str(tmp_path / "train.csv"), str(tmp_path / "val.csv")
    labels = list(range(n_classes))
    classes = [e["class"] for e in m["class_label_map"]]
    t["fragment_classifier_data"] = {
        "train": [{"class": classes, "path": [train], "label": labels}],
        "validation": [{"class": classes, "path": [val], "label": labels}]}
    t.update(batch_size=8, classifier_epochs=1, classifier_train_steps=3,
             classifier_validation_steps=1)
    m["string_processor"]["buffer_size"] = 64
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_train_cli_then_predict(tmp_path, name):
    """``train --device cpu`` on the narrow template (3 steps), then
    ``predict`` with the bundle; JAX loads the bundle and its forward
    equals the port's. The new templates get no int8 bundle (refused, see
    ``test_int8_refused_for_layer_zoo``); the variable-length one does."""
    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import load_model

    cfg = narrow(name)
    cfg_path = _train_data(tmp_path, name, cfg)
    out = tmp_path / "run"
    cli.main(["train", "-c", str(cfg_path), "-o", str(out), "--device",
              "cpu"])
    for f in ("params.msgpack", "project.yaml", "classes.yaml",
              "history.csv", "checkpoints/classifier/checkpoints.json"):
        assert (out / f).exists(), f
    assert (out / "int8").is_dir() == (name == "variable_length")
    tm, _, _ = load_model(out, device="cpu")
    crop = tm.crop_nt
    cli.main(["predict", "-i", FASTA, "-o", str(tmp_path / "pred"), "-m",
              str(out), "--fsize", str(crop), "--stride", str(crop),
              "--precision", "float32", "--device", "cpu", "--workers", "1"])
    rows = (tmp_path / "pred" / "test_contigs_default_jaeger.tsv"
            ).read_text().splitlines()
    assert len(rows) == 10
    jm, jvars, _, _ = jax_load_model(out)
    bases, lengths = _bases(np.random.default_rng(9), crop, "masked", 4)
    want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                            "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _close(got[k].numpy(), want[k], k)


def _forward_matches_jax(cfg, seed, n=6):
    """The masked program of ``cfg`` with seeded weights: every output
    equal to JAX's."""
    variables = _variables(cfg, seed)
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    bases, lengths = _bases(np.random.default_rng(seed), tm.crop_nt,
                            "masked", n)
    want = ModelBuilder(copy.deepcopy(cfg)).build().apply(
        variables, {"bases": jnp.asarray(bases),
                    "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], k)


@pytest.mark.parametrize("layer,config", [
    ("masked_bilstm", {"units": 8}),
    ("hyena_block", {"dim": 16}),
])
def test_bilstm_and_hyena_in_crossframe_match_jax(layer, config):
    """The configs the port refused before it had the two layers: a
    BiLSTM (8 units a direction, so 16 channels on) or a Hyena block
    inserted after the cross-frame template's attention."""
    cfg = narrow("crossframe")
    cfg["model"]["representation_learner"]["hidden_layers"].insert(
        3, {"name": layer, "config": config})
    _forward_matches_jax(cfg, 31)


def test_hyena_template_builds_and_matches_jax():
    """``train_config/hyena_fullcontig.yaml`` as it stands (dim 32, crop
    666 codons), which the port refused before."""
    _forward_matches_jax(jax_load_config(
        "train_config/hyena_fullcontig.yaml"), 32, n=4)


@pytest.mark.parametrize("name", ["dvf", "crossframe"])
def test_int8_refused_for_layer_zoo(tmp_path, setups, name):
    """``utils quantize --mode full_int8`` refuses the new templates
    (queue 1, item 10); ``dynamic`` writes a bundle that loads as float
    weights and computes the float forward."""
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.conversion import quantize_bundle

    bundle, crop = _bundle(tmp_path, setups, name)
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        quantize_bundle(bundle, tmp_path / "q8", mode="full_int8",
                        device="cpu")
    quantize_bundle(bundle, tmp_path / "dyn", mode="dynamic", device="cpu")
    model, _, _ = load_model(tmp_path / "dyn", device="cpu")
    bases, lengths = _bases(np.random.default_rng(2), crop, "dense", 2)
    with torch.inference_mode():
        out = model(torch.from_numpy(bases), torch.from_numpy(lengths))
    assert torch.isfinite(out["prediction"]).all()
