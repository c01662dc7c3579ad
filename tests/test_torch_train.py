"""The port's training against jaeger_tpu's, on the CPU, in f32.

Weights cross with ``params_from_jax``; inputs and labels are made with
numpy from a seed and handed to both. Covered: one train step of three
configs in each of their programs (the tiny masked-BN harness config; the
demo bundle's config, masked BN in residual blocks with a bounded cut,
regularizers; a narrow flagship-like DYT config, C = 16, three k5 residual
blocks, NMD taps and a reliability head) with the loss, every gradient
leaf, the batch statistics and the parameters after the step; the
reliability branch with frozen prefixes (AdamW decays the frozen leaves);
every loss; every optimizer on identical gradients; the callbacks and
metrics; the dispatcher's program choice; ``train --device cpu`` end to end
with resume.

Tolerances, and why:
* loss and batch statistics: 1e-5 of each leaf's largest magnitude
  (relative 1e-5 elementwise) — f32 sums in other orders;
* gradients: 5e-5 of each leaf's largest magnitude. The norm parameters'
  gradients (BN gamma, the DYT alpha, a scalar) are sums over every
  position with much cancellation; the worst measured is 2.1e-5 (a BN
  gamma of the demo config), the other leaves stay under 1e-5. A
  leaf whose largest gradient is below 1e-4 of the largest of any leaf
  has an exact gradient of zero (a conv bias right before a batch norm)
  and holds only rounding noise on both sides: it is compared at 1e-5 of
  the largest gradient of any leaf;
* parameters after one optimizer step: Adam's first step is
  ``lr * g / (|g| + 3.2e-6)``, close to ``lr * sign(g)``, so an element
  whose gradient is within its tolerance of zero may move by up to
  ``2 lr`` differently. Elements with ``|g|`` above 1e-4 and above 1e-3
  of the leaf's scale (their relative gradient error is at most 5e-2 and
  the update's sensitivity to it at most 3e-2) are compared at 2e-3 of
  the update, the rest bounded by ``2 lr``;
* optimizers on identical gradients: 1e-6 relative (XLA and PyTorch
  evaluate ``pow``, ``sqrt`` and ``rsqrt`` to within an ulp or so of each
  other; the update rules are the same operations in the same order).
"""

import copy
import csv
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.train import callbacks as jcb
from jaeger_tpu.train import loop as jloop
from jaeger_tpu.train import losses as jlosses
from jaeger_tpu.train import metrics as jmetrics
from jaeger_tpu.train import optimizers as jopt
from jaeger_tpu.utils.config import load_model_config as jax_load_config
from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                               params_from_jax)
from jaeger_tpu_torch.models.builder import build_model, mask_cut_plan
from jaeger_tpu_torch.train import callbacks as tcb
from jaeger_tpu_torch.train import loop as tloop
from jaeger_tpu_torch.train import losses as tlosses
from jaeger_tpu_torch.train import metrics as tmetrics
from jaeger_tpu_torch.train import optimizers as topt

TINY = "tests/data/tiny_config.yaml"
DEMO = "jaeger_tpu/data/models/demo/project.yaml"
TOL = 1e-5
GRAD_TOL = 5e-5


def _narrow_flagship() -> dict:
    """train_config/fragment_6class_1500bp.yaml cut to C = 16, a 40-codon
    crop and narrow heads."""
    cfg = jax_load_config("train_config/fragment_6class_1500bp.yaml")
    m = cfg["model"]
    m["embedding"]["embedding_size"] = 8
    m["string_processor"]["crop_size"] = 40
    for layer in m["representation_learner"]["hidden_layers"]:
        if "filters" in (layer.get("config") or {}):
            layer["config"]["filters"] = 16
    m["reliability_model"]["hidden_layers"][0]["config"]["units"] = 8
    return cfg


def _demo() -> dict:
    cfg = jax_load_config(DEMO)
    for layer in cfg["model"]["classifier"]["hidden_layers"]:
        if layer["name"] == "dropout":
            layer["config"]["rate"] = 0.0    # no random numbers to share
    return cfg


CONFIGS = {"tiny": lambda: jax_load_config(TINY), "demo": _demo,
           "narrow": _narrow_flagship}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


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


def _init_variables(cfg, seed):
    """Seeded flax variables for ``cfg`` (the port's ``init_params``, a
    faster start than JAX's eager init; the tree is the same)."""
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
    return tree


@pytest.fixture(scope="module")
def setups():
    """config name -> (config, jax model, randomized variables)."""
    out = {}
    for name, make in CONFIGS.items():
        cfg = make()
        model = ModelBuilder(copy.deepcopy(cfg)).build()
        variables = _randomize(_init_variables(cfg, len(name)),
                               seed=len(name))
        out[name] = (cfg, model, variables)
    return out


def _batch(rng, crop, program, n_classes, n=6):
    """Host batch for ``program``: dense windows, one interior N per row
    (bounded), or N runs and short rows (masked)."""
    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.full(n, crop, np.int32)
    if program == "bounded":
        bases[np.arange(n), rng.integers(20, crop - 20, size=n)] = 4
    elif program == "masked":
        bases[0, 20:60] = 4
        lengths[1] = crop // 2
        bases[2, : crop // 3] = rng.integers(0, 9, size=crop // 3)
    labels = np.zeros((n, n_classes), np.float32)
    labels[np.arange(n), rng.integers(0, n_classes, size=n)] = 1.0
    return {"bases": bases, "lengths": lengths, "labels": labels}


def _programs(cfg):
    progs = [("dense", {"assume_dense": True}), ("masked", {})]
    plans = mask_cut_plan(cfg["model"]["representation_learner"]) or []
    progs += [(f"bounded:{cut}", {"mask_layers": cut}) for cut, _, _ in plans]
    return progs


STEP_CASES = [(c, p) for c in ("tiny", "demo", "narrow")
              for p in {"tiny": ["dense", "masked"],
                        "demo": ["dense", "masked", "bounded"],
                        "narrow": ["dense", "masked", "bounded"]}[c]]


def _capture():
    """An optax stage that passes the gradients on and keeps them as its
    state, so that one jitted JAX step also returns its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_step(model, variables, cfg, batch, step_cfg, tx):
    """JAX's train step (jaeger_tpu.train.loop) and its gradients (after
    ``_mask_frozen``)."""
    state = jloop.TrainState.create(variables, optax.chain(_capture(), tx))
    step = jax.jit(jloop.make_train_step(model, step_cfg))
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, metrics = step(state, dev, jax.random.PRNGKey(0))
    return new_state, metrics, new_state.opt_state[0]


def _torch_step(cfg, variables, batch, step_cfg):
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    train_cfg = cfg.get("training", {})
    tx = topt.make_optimizer(train_cfg.get("optimizer", "adam"),
                             train_cfg.get("optimizer_params", {}))
    state = tloop.TrainState.create(tm, tx)
    step = tloop.make_train_step(tm, step_cfg)
    state, metrics = step(state, tloop.to_device(batch, "cpu"))
    return tm, state, metrics


def _close(got, want, what, tol=TOL, overall=None):
    """``overall``: the largest gradient of any leaf (see the module
    docstring for leaves far below it)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    if overall is not None and scale < 1e-4 * overall:
        scale = overall
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _check_params(tm, params_before, new_params, grads, lr):
    """Parameters after the step (module docstring: Adam's sign-like first
    step)."""
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in tm.named_parameters()}
    want = _flat(new_params)
    before = _flat(params_before)
    assert set(got) == set(want)
    for k in want:
        g = np.abs(np.asarray(grads[k]))
        big = (g > 1e-4) & (g > 1e-3 * float(g.max()))
        du_got, du_want = got[k] - before[k], want[k] - before[k]
        np.testing.assert_allclose(du_got[big], du_want[big], rtol=2e-3,
                                   atol=1e-7, err_msg=k)
        assert np.all(np.abs(du_got - du_want) <= 2 * lr + 1e-7), k


@pytest.mark.parametrize("name,program", STEP_CASES)
def test_train_step_matches_jax(setups, name, program):
    cfg, model, variables = setups[name]
    train_cfg = cfg.get("training", {})
    rng = np.random.default_rng(11)
    n_classes = int(cfg["model"]["classifier_out_dim"])
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    progs = dict(_programs(cfg))
    key = program if program != "bounded" else next(
        p for p in progs if p.startswith("bounded"))
    kw = progs[key]
    batch = _batch(rng, crop, program.split(":")[0], n_classes)
    loss_name = train_cfg.get("loss_classifier", "categorical_crossentropy")
    loss_params = train_cfg.get("loss_params_classifier", {})
    reg = tuple(ModelBuilder(copy.deepcopy(cfg)).regularizer_specs())
    tm0 = build_model(copy.deepcopy(cfg))
    assert tuple(tm0.regularizer_specs()) == reg
    jcfg = jloop.StepConfig(loss_name=loss_name, loss_params=loss_params,
                            reg_specs=reg, heads=("prediction",), **kw)
    tx = jopt.make_optimizer(train_cfg.get("optimizer", "adam"),
                             train_cfg.get("optimizer_params", {}))
    new_state, jm, grads = _jax_step(model, variables, cfg, batch, jcfg, tx)
    tcfg = tloop.StepConfig(loss_name=loss_name, loss_params=loss_params,
                            reg_specs=reg, heads=("prediction",), **kw)
    tm, state, tmet = _torch_step(cfg, variables, batch, tcfg)
    for m in ("loss", "reg_loss", "total_loss", "grad_norm", "accuracy"):
        _close(float(tmet[m]), float(jm[m]), m)
    jg = _flat(grads)
    assert set(state.grads) == set(jg)
    overall = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        _close(state.grads[k].numpy(), jg[k], f"grad {k}", GRAD_TOL,
               overall)
    want_stats = _flat(new_state.batch_stats) if new_state.batch_stats else {}
    got_stats = {k.replace(".", "/"): v.numpy()
                 for k, v in tm.state_dict().items()
                 if k.endswith(("moving_mean", "moving_variance"))}
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], f"batch_stats {k}")
    lr = float(train_cfg.get("optimizer_params", {}).get("learning_rate",
                                                         1e-3))
    _check_params(tm, variables["params"], new_state.params, jg, lr)


def test_bounded_gradients_equal_masked(setups):
    """On a batch that qualifies for a cut the bounded program is the
    masked program: equal loss, gradients and batch statistics."""
    for name in ("demo", "narrow"):
        cfg, _, variables = setups[name]
        rng = np.random.default_rng(5)
        crop = build_model(copy.deepcopy(cfg)).crop_nt
        batch = _batch(rng, crop, "bounded",
                       int(cfg["model"]["classifier_out_dim"]))
        runs = []
        for cut in [None] + [c for c, _, _ in mask_cut_plan(
                cfg["model"]["representation_learner"])]:
            step_cfg = tloop.StepConfig(heads=("prediction",),
                                        mask_layers=cut)
            tm, state, met = _torch_step(cfg, variables, batch, step_cfg)
            runs.append((float(met["loss"]), state.grads,
                         {k: v.clone() for k, v in tm.state_dict().items()
                          if "moving" in k}))
        for loss, grads, stats in runs[1:]:
            assert loss == pytest.approx(runs[0][0], rel=1e-6)
            for k in grads:
                _close(grads[k].numpy(), runs[0][1][k].numpy(), k, GRAD_TOL)
            for k in stats:
                _close(stats[k].numpy(), runs[0][2][k].numpy(), k)


def test_reliability_branch_with_frozen_prefixes(setups):
    """The reliability step: only the reliability head's gradients are
    nonzero, the classifier head is not run, the rep's batch statistics
    and NMD moving means update, and AdamW decays the frozen parameters by
    ``lr * wd`` as the JAX chain does."""
    cfg, model, variables = setups["narrow"]
    train_cfg = cfg["training"]
    rng = np.random.default_rng(3)
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    batch = _batch(rng, crop, "masked", 1)
    batch["labels"] = rng.integers(0, 2, size=(6, 1)).astype(np.float32)
    frozen = ("embedding", "rep", "classifier", "projection")
    common = dict(loss_name="binary_crossentropy",
                  loss_params={"from_logits": True},
                  output_key="reliability", frozen_prefixes=frozen,
                  heads=("reliability",))
    tx = jopt.make_optimizer(train_cfg["optimizer"],
                             train_cfg["optimizer_params"])
    new_state, jm, grads = _jax_step(model, variables, cfg, batch,
                                     jloop.StepConfig(**common), tx)
    tm, state, tmet = _torch_step(cfg, variables, batch,
                                  tloop.StepConfig(**common))
    _close(float(tmet["loss"]), float(jm["loss"]), "loss")
    jg = _flat(grads)
    for k in jg:
        _close(state.grads[k].numpy(), jg[k], f"grad {k}", GRAD_TOL)
        if k.startswith(frozen):
            assert not state.grads[k].any(), k
    assert any(state.grads[k].any() for k in jg
               if k.startswith("reliability"))
    want_stats = _flat(new_state.batch_stats)
    for k, v in tm.state_dict().items():
        if "moving" in k:
            _close(v.numpy(), want_stats[k.replace(".", "/")], k)
    lr = train_cfg["optimizer_params"]["learning_rate"]
    wd = train_cfg["optimizer_params"]["weight_decay"]
    before = _flat(variables["params"])
    after = {k.replace(".", "/"): v.detach().numpy()
             for k, v in tm.named_parameters()}
    want_after = _flat(new_state.params)
    for k in before:
        if k.startswith(frozen):
            np.testing.assert_allclose(after[k], before[k] * (1 - lr * wd),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(after[k], want_after[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)


# --- losses ---------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(8, 5)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=8)]
    cw = rng.random(5).astype(np.float32) + 0.5
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = torch.from_numpy
    cases = [
        ("cce", lambda m, x: m.categorical_crossentropy(x(labels), x(logits))),
        ("cce_smooth_weights", lambda m, x: m.categorical_crossentropy(
            x(labels), x(logits), label_smoothing=0.1,
            class_weights=x(cw))),
        ("cce_probs", lambda m, x: m.categorical_crossentropy(
            x(labels), x(probs), from_logits=False)),
        ("sparse", lambda m, x: m.sparse_categorical_crossentropy(
            x(labels.argmax(-1)), x(logits), class_weights=x(cw))),
        ("bce", lambda m, x: m.binary_crossentropy(
            x(labels[:, :1]), x(logits[:, :1]))),
        ("bce_probs_weights", lambda m, x: m.binary_crossentropy(
            x(labels[:, :1]), x(1 / (1 + np.exp(-logits[:, :1]))),
            from_logits=False, class_weights=x(cw[:2]))),
        ("mse", lambda m, x: m.mse(x(labels), x(logits))),
        ("hierarchical", lambda m, x: m.hierarchical_loss(
            x(labels), x(logits), (0, 0, 1, 1, 1), ((0, 1), (2, 3, 4)))),
    ]
    for name, fn in cases:
        want = float(fn(jlosses, jnp.asarray))
        got = float(fn(tlosses, t))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), name
    params = {"rep/masked_conv1d_0/kernel": rng.normal(size=(3, 4)),
              "embedding/embedding": rng.normal(size=(5, 2)),
              "classifier/dense_0/bias": rng.normal(size=(3,))}
    specs = [(r"rep/.*masked_conv1d_0.*/kernel", "l2", 0.01),
             (r"embedding", "l1", 0.1)]
    nested = {"rep": {"masked_conv1d_0": {"kernel": params[
        "rep/masked_conv1d_0/kernel"]}},
              "embedding": {"embedding": params["embedding/embedding"]},
              "classifier": {"dense_0": {"bias": params[
                  "classifier/dense_0/bias"]}}}
    want = float(jlosses.regularization_loss(
        jax.tree_util.tree_map(jnp.asarray, nested), specs))
    got = float(tlosses.regularization_loss(
        {k: t(v.astype(np.float32)) for k, v in params.items()}, specs))
    assert got == pytest.approx(want, rel=1e-6)


# --- optimizers -----------------------------------------------------------

OPT_CASES = [
    ("adam", {"learning_rate": 0.01, "clipnorm": 0.5}, 1),
    ("adamw", {"learning_rate": 0.01, "weight_decay": 0.05,
               "global_clipnorm": 0.7}, 1),
    ("adam", {"learning_rate": {"initial_learning_rate": 0.02,
                                "decay_steps": 4, "warmup_steps": 1,
                                "alpha": 0.1}}, 1),
    ("adam", {"learning_rate": 0.01}, 2),
    ("muon", {"learning_rate": 0.01}, 1),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True}, 1),
    ("sgd", {"learning_rate": 0.1}, 1),
    ("rmsprop", {"learning_rate": 0.01, "momentum": 0.5, "centered": True},
     1),
    ("rmsprop", {"learning_rate": 0.01}, 1),
    ("adagrad", {"learning_rate": 0.1, "clipnorm": 1.0}, 1),
]


@pytest.mark.parametrize("name,params,acc", OPT_CASES)
def test_optimizer_matches_optax(name, params, acc):
    """Three steps on identical gradients, a set_learning_rate between the
    second and the third (a no-op for the schedule)."""
    rng = np.random.default_rng(hash(name) % 1000)
    shapes = {"rep/conv/kernel": (3, 4, 4), "classifier/dense_0/kernel": (4, 3),
              "classifier/dense_0/bias": (3,),
              "embedding/embedding": (5, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *scopes, leaf = k.split("/")
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = jnp.asarray(v)
        return out

    jtx = jopt.make_optimizer(name, copy.deepcopy(params),
                              accumulation_steps=acc)
    ttx = topt.make_optimizer(name, copy.deepcopy(params),
                              accumulation_steps=acc)
    jp, tp = nest(p), {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
             for k, v in p.items()}
        ju, js = jtx.update(nest(g), js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        want = _flat(jp)
        for k in want:
            np.testing.assert_allclose(tp[k].numpy(), want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {k} "
                                                          f"step {step}")
        assert topt.get_learning_rate(ts) == (
            None if jopt.get_learning_rate(js) is None
            else pytest.approx(jopt.get_learning_rate(js)))
        if step == 1:
            js = jopt.set_learning_rate(js, 0.003)
            ts = topt.set_learning_rate(ts, 0.003)


# --- callbacks and metrics --------------------------------------------------


def test_callbacks_match_jax(tmp_path):
    seq = [1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.86, 0.87, 0.88]
    for kw in ({"patience": 2}, {"patience": 1, "min_delta": 0.05},
               {"patience": 2, "baseline": 0.85, "restore_best_weights": True},
               {"patience": 0, "start_from_epoch": 2},
               {"monitor": "val_accuracy", "patience": 2}):
        j, t = jcb.EarlyStopping(**kw), tcb.EarlyStopping(**kw)
        for epoch, v in enumerate(seq):
            metrics = {"val_loss": v, "val_accuracy": 1 - v}
            p = {"a": torch.tensor([float(epoch)])}
            assert t.on_epoch_end(metrics, p, epoch) == j.on_epoch_end(
                metrics, None, epoch), (kw, epoch)
            assert t.state() == j.state()
        if kw.get("restore_best_weights"):
            assert t.best_params is not None
    for kw in ({"patience": 1, "factor": 0.5},
               {"patience": 2, "factor": 0.2, "cooldown": 1, "min_lr": 1e-4},
               {"monitor": "val_accuracy", "patience": 1}):
        j, t = jcb.ReduceLROnPlateau(**kw), tcb.ReduceLROnPlateau(**kw)
        lr_j = lr_t = 1e-3
        for epoch, v in enumerate(seq):
            metrics = {"val_loss": v, "val_accuracy": 1 - v}
            nj = j.on_epoch_end(metrics, lr_j, epoch)
            nt = t.on_epoch_end(metrics, lr_t, epoch)
            assert nt == nj, (kw, epoch)
            lr_j, lr_t = nj or lr_j, nt or lr_t
            assert t.state() == j.state()
    assert tcb.TerminateOnNaN().on_step(float("nan"))
    built = tcb.build_callbacks([
        {"name": "EarlyStopping", "params": {"patience": 3}},
        {"name": "ReduceLROnPlateau"}, {"name": "TerminateOnNaN"},
        {"name": "CSVLogger", "params": {"filename": str(tmp_path / "h.csv")}}])
    assert set(built) == {"early_stopping", "reduce_lr", "nan_guard",
                          "csv_logger"}
    built["csv_logger"].on_epoch_end(0, {"loss": 1.5})
    built["csv_logger"].close()
    assert list(csv.DictReader(open(tmp_path / "h.csv"))) == [
        {"epoch": "0", "loss": "1.5"}]


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, size=50)
    logits = rng.normal(size=(50, 4))
    for fn in ("precision_for_class", "recall_for_class",
               "specificity_for_class", "f1_for_class"):
        for c in range(4):
            assert getattr(tmetrics, fn)(y, logits, c) == getattr(
                jmetrics, fn)(y, logits, c)
    assert tmetrics.macro_f1_score(y, logits, 4) == jmetrics.macro_f1_score(
        y, logits, 4)
    assert (tmetrics.confusion_matrix(y, logits, 4)
            == jmetrics.confusion_matrix(y, logits, 4)).all()
    yb = rng.integers(0, 2, size=30)
    lb = rng.normal(size=30)
    assert tmetrics.binary_f1_score(yb, lb) == jmetrics.binary_f1_score(yb, lb)


# --- the dispatcher and the command ----------------------------------------


def test_dispatcher_selects_programs(setups):
    cfg, _, variables = setups["narrow"]
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    tx = topt.make_optimizer("adam", {"learning_rate": 1e-3})
    state = tloop.TrainState.create(tm, tx)
    step = tloop.make_dispatching_train_step(
        tm, tloop.StepConfig(heads=("prediction",)), "cpu")
    rng = np.random.default_rng(2)
    for program in ("dense", "bounded", "masked"):
        state, m = step(state, _batch(rng, tm.crop_nt, program, 6))
        assert math.isfinite(float(m["loss"]))
    assert step.program_counts == {"dense": 1, "bounded": 1, "masked": 1}


def test_train_cli_cpu_bundle_loads_in_both_and_resumes(tmp_path):
    """``train --device cpu`` on the tiny config writes the bundle, which
    jaeger_tpu loads and runs to 1e-5 of the port's forward; one epoch
    then a resumed second equals two epochs run straight."""
    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import load_model

    cfg = jax_load_config(TINY)
    cfg["training"]["classifier_epochs"] = 2
    two = tmp_path / "two.yaml"
    import yaml

    two.write_text(yaml.safe_dump(cfg))
    cli.main(["train", "-c", str(two), "-o", str(tmp_path / "straight"),
              "--device", "cpu"])
    out = tmp_path / "straight"
    for f in ("params.msgpack", "project.yaml", "classes.yaml",
              "history.csv", "checkpoints/classifier/checkpoints.json"):
        assert (out / f).exists(), f
    rows = list(csv.DictReader(open(out / "history.csv")))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert (out / "int8").is_dir()

    cli.main(["train", "-c", str(two), "-o", str(tmp_path / "resumed"),
              "--device", "cpu", "--epochs", "1"])
    cli.main(["train", "-c", str(two), "-o", str(tmp_path / "resumed"),
              "--device", "cpu", "--from-last-checkpoint",
              "--ignore-convergence"])
    a = torch.load(out / "checkpoints/classifier/epoch_001.pt")
    b = torch.load(tmp_path / "resumed/checkpoints/classifier/epoch_001.pt")
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)

    jm, jvars, _, _ = jax_load_model(out)
    tm, _, _ = load_model(out, device="cpu")
    rng = np.random.default_rng(9)
    bases = rng.integers(0, 9, size=(4, tm.crop_nt)).astype(np.uint8)
    lengths = np.array([tm.crop_nt, 50, 200, tm.crop_nt], np.int32)
    want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                            "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _close(got[k].numpy(), want[k], k)


def test_train_refuses_unported_paths(tmp_path):
    """Multi-device training is refused, citing its ROADMAP.md item; the
    self-supervised pretraining runs, and on a config without a
    ``projection`` section (the tiny one) it is a no-op, as in JAX."""
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.train import train_fragment_core

    r = train_fragment_core(TINY, str(tmp_path / "a"), device="cpu",
                            self_supervised_pretraining=True, save=False)
    assert "projection" not in r["history"] and r["history"]["classifier"]
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["train", "-c", TINY, "-o", str(tmp_path / "b"),
                  "--device", "cpu", "--coordinator", "localhost:1234"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_fragment_core(TINY, str(tmp_path / "c"))


def test_evaluators_and_threshold_match_jax(tmp_path):
    """The CSV and npz evaluators on the demo bundle against JAX's model on
    the same rows and tokens (``jaeger_tpu``'s own loader and engine take
    many seconds to build; the weights come from the bundle's msgpack):
    logits to 1e-5 of their scale, labels, confusion matrices and metric
    rows equal. The threshold tuning and calibration copies give JAX's
    tables."""
    from jaeger_tpu.postprocess import threshold as jthr
    from jaeger_tpu.seqops.windows import BASE_N, encode_ascii
    from jaeger_tpu.train import evaluate as jev
    from jaeger_tpu_torch.models.artifacts import read_flax_msgpack
    from jaeger_tpu_torch.postprocess import threshold as tthr
    from jaeger_tpu_torch.train import evaluate as tev

    demo = "jaeger_tpu/data/models/demo"
    cfg = jax_load_config(f"{demo}/project.yaml")
    jm = ModelBuilder(copy.deepcopy(cfg)).build()
    jvars = read_flax_msgpack(f"{demo}/params.msgpack")
    forward = jax.jit(lambda inputs: jm.apply(jvars, inputs)["prediction"])

    def check(got, want_logits, y_want):
        row, cm, logits, y = got
        _close(logits, want_logits, "logits")
        assert (y == y_want).all()
        k = want_logits.shape[1]
        assert row == pytest.approx(jev.metrics_row(y, want_logits, k))
        assert (cm == jmetrics.confusion_matrix(y, want_logits, k)).all()

    csv_path = "tests/data/tiny_train.csv"
    rows = [line.strip().split(",") for line in open(csv_path)]
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    bases = np.full((len(rows), crop), BASE_N, np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, (_, seq) in enumerate(rows):
        ids = encode_ascii(seq[:crop])
        bases[i, :ids.shape[0]] = ids
        lengths[i] = ids.shape[0]
    check(tev.evaluate_bundle_on_csv(demo, csv_path, batch_size=64,
                                     device="cpu"),
          np.asarray(forward({"bases": bases, "lengths": lengths})),
          np.array([int(r[0]) for r in rows]))

    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 65, size=(10, 6, 160)).astype(np.int32)
    labels = rng.integers(0, 3, size=10)
    np.savez(tmp_path / "tokens.npz", translated=tokens, labels=labels)
    check(tev.evaluate_bundle_on_npz(demo, tmp_path / "tokens.npz",
                                     batch_size=4, device="cpu"),
          np.asarray(forward({"translated": tokens})), labels)

    scores = rng.random(200)
    ood = (rng.random(200) < scores).astype(int)
    assert tthr.tune_reliability_threshold(scores, ood) == \
        jthr.tune_reliability_threshold(scores, ood)
    assert tthr.calibration_summary(scores, ood) == \
        jthr.calibration_summary(scores, ood)
