"""The port's self-supervised projection pretraining against jaeger_tpu's,
on the CPU.

Covered: ``ArcFaceLoss`` (``class_weights`` carried across from JAX's
``arcface.init``; one-hot and sparse labels; f32 and bf16 embeddings),
``npairs_loss`` and ``supervised_contrastive_loss``; the projection head's
output with weights carried across; a bundle the port's ``train`` writes for
a projection config loading in ``jaeger_tpu.models.artifacts.load_model``;
one projection step against JAX's ``proj_loss`` / ``proj_step`` arithmetic
(``jaeger_tpu/commands/train.py:624-650``) on the same weights and batch; and
the stage's wiring in ``train_fragment_core``.

Tolerances, and why:
* ArcFace, npairs and supervised contrastive losses, the projection output:
  1e-5 of the largest magnitude (f32 sums in other orders); bf16 embeddings:
  the loss in f32 on the same bf16 values (1e-5), the embeddings' gradient
  within bf16 rounding (one bf16 ulp, 2**-8 relative, of the scale);
* the projection step: the loss to 1e-5, every gradient leaf to 5e-5 of its
  largest magnitude (the module docstring of ``tests/test_torch_train.py``
  says why; leaves far below the largest gradient are held at 1e-5 of it),
  the batch statistics to 1e-5 and the parameters after the optimizer step
  as ``tests/test_torch_train.py::_check_params`` holds them.
"""

import copy

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.train import losses as jlosses
from jaeger_tpu.train import optimizers as jopt
from jaeger_tpu_torch.commands.train import (make_projection_step,
                                             train_fragment_core)
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.train import losses as tlosses
from jaeger_tpu_torch.train import optimizers as topt
from jaeger_tpu_torch.train.loop import to_device

from tests.test_builder import BASE_CONFIG
from tests.test_torch_train import (GRAD_TOL, TOL, _batch, _check_params,
                                    _close, _flat, _init_variables,
                                    _narrow_flagship, _randomize)

PROJECTION = {
    "input_shape": 16, "margin": 0.5, "scale": 30,
    "hidden_layers": [
        {"name": "dense", "config": {"units": 8, "activation": "relu",
                                     "kernel_regularizer": "l2",
                                     "kernel_regularizer_w": 1e-3}},
        {"name": "dense", "config": {"units": 4}},
    ],
}


def _with_projection(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["model"]["projection"] = copy.deepcopy(PROJECTION)
    return cfg


def _builder_cfg() -> dict:
    """``tests/test_builder.py``'s layout with the projection head of
    ``test_projection_head``; the classifier's dropout is off (the
    projection step does not run it, the forward test does)."""
    cfg = _with_projection(BASE_CONFIG)
    cfg["model"]["classifier"]["hidden_layers"][0]["config"]["rate"] = 0.0
    cfg["training"] = {"optimizer": "adam",
                       "optimizer_params": {"learning_rate": 1e-3}}
    return cfg


CONFIGS = {"builder": _builder_cfg,
           "narrow": lambda: _with_projection(_narrow_flagship())}


def _arcface_case(labels_kind: str, seed: int = 3, n: int = 12, c: int = 5,
                  d: int = 7):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    sparse = rng.integers(0, c, size=n)
    labels = (np.eye(c, dtype=np.float32)[sparse] if labels_kind == "onehot"
              else sparse.astype(np.int32))
    return emb, labels


@pytest.mark.parametrize("labels_kind,dtype", [
    ("onehot", "float32"), ("sparse", "float32"), ("onehot", "bfloat16"),
    ("sparse", "bfloat16")])
def test_arcface_loss_and_gradients_match_jax(labels_kind, dtype):
    c, d = 5, 7
    emb, labels = _arcface_case(labels_kind, c=c, d=d)
    onehot = labels_kind == "onehot"
    jarc = jlosses.ArcFaceLoss(num_classes=c, embedding_dim=d, margin=0.5,
                               scale=30.0, onehot=onehot)
    jvars = jarc.init(jax.random.PRNGKey(1), jnp.asarray(labels),
                      jnp.zeros((len(labels), d)))
    jemb = jnp.asarray(emb).astype(dtype)

    def jloss(params, e):
        return jarc.apply({"params": params}, jnp.asarray(labels), e)

    want, (g_w, g_e) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jvars["params"], jemb)

    tarc = tlosses.ArcFaceLoss(c, d, margin=0.5, scale=30.0, onehot=onehot,
                               generator=torch.Generator().manual_seed(1))
    assert tarc.class_weights.dtype == torch.float32
    assert tuple(tarc.class_weights.shape) == (c, d)
    with torch.no_grad():
        tarc.class_weights.copy_(torch.from_numpy(
            np.array(jvars["params"]["class_weights"])))
    temb = torch.from_numpy(np.asarray(jemb.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = tarc(torch.from_numpy(labels), temb)
    got.backward()
    assert got.dtype == torch.float32
    _close(float(got.detach()), float(want), "loss")
    _close(tarc.class_weights.grad.numpy(), g_w["class_weights"],
           "class_weights grad")
    ge = temb.grad.float().numpy()
    if dtype == "float32":
        _close(ge, g_e, "embeddings grad")
    else:
        assert temb.grad.dtype == torch.bfloat16
        _close(ge, np.asarray(g_e, np.float32), "embeddings grad",
               tol=2.0 ** -8)


def test_arcface_init_is_glorot_uniform_from_the_generator():
    a = tlosses.ArcFaceLoss(6, 64, generator=torch.Generator().manual_seed(9))
    b = tlosses.ArcFaceLoss(6, 64, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a.class_weights, b.class_weights)
    lim = (6.0 / (6 + 64)) ** 0.5
    assert float(a.class_weights.abs().max()) <= lim
    assert float(a.class_weights.abs().max()) > 0.8 * lim


@pytest.mark.parametrize("kind", ["npairs", "supcon_sparse", "supcon_onehot",
                                  "supcon_t0.1"])
def test_contrastive_losses_match_jax(kind):
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(10, 6)).astype(np.float32)
    sparse = rng.integers(0, 3, size=10)
    if kind == "npairs":
        logits = rng.normal(size=(10, 10)).astype(np.float32)
        want = jlosses.npairs_loss(jnp.asarray(sparse), jnp.asarray(logits))
        got = tlosses.npairs_loss(torch.from_numpy(sparse),
                                  torch.from_numpy(logits))
    else:
        labels = (np.eye(3, dtype=np.float32)[sparse]
                  if kind == "supcon_onehot" else sparse)
        t = 0.1 if kind == "supcon_t0.1" else 1.0
        want = jlosses.supervised_contrastive_loss(
            jnp.asarray(labels), jnp.asarray(feats), temperature=t)
        got = tlosses.supervised_contrastive_loss(
            torch.from_numpy(labels), torch.from_numpy(feats),
            temperature=t)
    _close(float(got), float(want), kind)


def test_projection_head_output_matches_jax():
    """The projection head over the pooled representation, with JAX's
    initial weights carried across, in f32 on masked inputs: equal to
    JAX's to 1e-5, whether asked for by ``with_projection`` or by
    ``heads``; no other head asks for it."""
    cfg = _builder_cfg()
    b = ModelBuilder(copy.deepcopy(cfg))
    jm, jvars = b.init()
    assert "projection" in jvars["params"]
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(jax.tree.map(np.asarray, jvars)))
    tm.eval()
    rng = np.random.default_rng(0)
    crop = tm.crop_nt
    bases = rng.integers(0, 4, size=(5, crop)).astype(np.uint8)
    bases[1, 30:50] = 4
    lengths = np.array([crop, crop, 70, 40, crop], np.int32)
    want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                            "lengths": jnp.asarray(lengths)},
                    with_projection=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths),
                 with_projection=True)
        only = tm(torch.from_numpy(bases), torch.from_numpy(lengths),
                  heads=("projection",))
        plain = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    assert got["projection"].shape == (5, 4)
    for k in want:
        _close(got[k].numpy(), want[k], k)
    assert set(only) == {"embedding", "projection"}
    _close(only["projection"].numpy(), want["projection"], "heads")
    assert "projection" not in plain


def test_port_bundle_of_a_projection_config_loads_in_jax(tmp_path):
    """``train`` of the port on the tiny config with a projection section
    writes the ``projection`` subtree, so jaeger_tpu restores the bundle
    against its template, and JAX's projection output on it equals the
    port's to 1e-5 (f32)."""
    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu_torch.models.artifacts import load_model

    cfg = _with_projection(yaml.safe_load(open("tests/data/tiny_config.yaml")))
    cfg["model"]["projection"]["input_shape"] = 8
    path = tmp_path / "proj.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_fragment_core(str(path), str(tmp_path / "out"), device="cpu")
    jm, jvars, _, _ = jax_load_model(tmp_path / "out")
    assert set(jvars["params"]["projection"]) == {"dense_0", "dense_1"}
    tm, _, _ = load_model(tmp_path / "out", device="cpu")
    rng = np.random.default_rng(2)
    bases = rng.integers(0, 9, size=(4, tm.crop_nt)).astype(np.uint8)
    lengths = np.array([tm.crop_nt, 50, 200, tm.crop_nt], np.int32)
    want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                            "lengths": jnp.asarray(lengths)},
                    with_projection=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths),
                 with_projection=True)
    for k in want:
        _close(got[k].numpy(), want[k], k)


def _jax_proj_step(model, variables, arcface, af_params, batch, reg_specs,
                   tx):
    """JAX's ``proj_loss`` and ``proj_step`` (``jaeger_tpu/commands/
    train.py:624-650``) on one batch: (loss, grads, new batch stats, new
    params)."""
    combined = {"model": variables["params"], "arcface": af_params}
    stats = variables.get("batch_stats", {})

    def proj_loss(params, stats, batch, step_rng):
        v = {"params": params["model"]}
        if stats:
            v["batch_stats"] = stats
        out, updates = model.apply(
            v, {k: x for k, x in batch.items() if k != "labels"},
            train=True, with_projection=True, heads=("projection",),
            rngs={"dropout": step_rng},
            mutable=["batch_stats"] if stats else [])
        loss = arcface.apply({"params": params["arcface"]},
                             batch["labels"], out["projection"])
        reg = jlosses.regularization_loss(params["model"], list(reg_specs))
        return loss + reg, (loss, updates.get("batch_stats", stats))

    @jax.jit
    def proj_step(params, stats, opt_state, batch, step_rng):
        (_, (loss, new_stats)), grads = jax.value_and_grad(
            proj_loss, has_aux=True)(params, stats, batch, step_rng)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, loss, grads

    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    return proj_step(combined, stats, tx.init(combined), dev,
                     jax.random.PRNGKey(0))


@pytest.mark.parametrize("name,program", [("builder", "masked"),
                                          ("narrow", "masked"),
                                          ("narrow", "dense")])
def test_projection_step_matches_jax(name, program):
    cfg = CONFIGS[name]()
    train_cfg = cfg["training"]
    n_classes = int(cfg["model"]["classifier_out_dim"])
    model = ModelBuilder(copy.deepcopy(cfg)).build()
    variables = _randomize(_init_variables(cfg, 4), seed=4)
    assert "projection" in variables["params"]
    rng = np.random.default_rng(13)
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    batch = _batch(rng, tm.crop_nt, program, n_classes, n=8)
    reg = tuple(ModelBuilder(copy.deepcopy(cfg)).regularizer_specs())
    assert tuple(tm.regularizer_specs()) == reg
    assert any(p.startswith("projection") for p, _, _ in reg) or \
        name != "builder"

    proj_dim = int(PROJECTION["hidden_layers"][-1]["config"]["units"])
    jarc = jlosses.ArcFaceLoss(num_classes=n_classes, embedding_dim=proj_dim,
                               margin=0.5, scale=30.0)
    af = jarc.init(jax.random.PRNGKey(5), jnp.zeros((2, n_classes)),
                   jnp.zeros((2, proj_dim)))["params"]
    jtx = jopt.make_optimizer(train_cfg.get("optimizer", "adam"),
                              train_cfg.get("optimizer_params", {}))
    new_params, new_stats, jloss, jgrads = _jax_proj_step(
        model, variables, jarc, af, batch, reg, jtx)

    tarc = tlosses.ArcFaceLoss(n_classes, proj_dim, margin=0.5, scale=30.0)
    with torch.no_grad():
        tarc.class_weights.copy_(torch.from_numpy(
            np.array(af["class_weights"])))
    ttx = topt.make_optimizer(train_cfg.get("optimizer", "adam"),
                              train_cfg.get("optimizer_params", {}))
    step = make_projection_step(tm, tarc, ttx, reg)
    from jaeger_tpu_torch.commands.train import projection_params

    opt_state = ttx.init({k: p.detach() for k, p in
                          projection_params(tm, tarc).items()})
    tm.train()
    _, loss = step(opt_state, to_device(batch, "cpu"))
    _close(float(loss), float(jloss), "loss")
    jg = _flat(jgrads)
    assert set(step.grads) == set(jg)
    overall = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        _close(step.grads[k].numpy(), jg[k], f"grad {k}", GRAD_TOL, overall)
    # the heads the step does not run get exact zeros
    assert all(float(step.grads[k].abs().max()) == 0.0 for k in jg
               if k.startswith("model/classifier"))
    want_stats = _flat(new_stats) if new_stats else {}
    got_stats = {k.replace(".", "/"): v.numpy()
                 for k, v in tm.state_dict().items()
                 if k.endswith(("moving_mean", "moving_variance"))}
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], f"batch_stats {k}")
    lr = float(train_cfg.get("optimizer_params", {}).get("learning_rate",
                                                         1e-3))
    _check_params(tm, variables["params"], new_params["model"],
                  {k[len("model/"):]: v for k, v in jg.items()
                   if k.startswith("model/")}, lr)
    got_w = tarc.class_weights.detach().numpy()
    du = got_w - np.asarray(af["class_weights"])
    du_want = (np.asarray(new_params["arcface"]["class_weights"])
               - np.asarray(af["class_weights"]))
    assert np.all(np.abs(du - du_want) <= 2 * lr + 1e-7)


def _tiny_projection_config(tmp_path, with_projection=True) -> str:
    cfg = yaml.safe_load(open("tests/data/tiny_config.yaml"))
    if with_projection:
        cfg = _with_projection(cfg)
        cfg["model"]["projection"]["input_shape"] = 8
    cfg["training"]["projection_epochs"] = 2
    cfg["training"]["classifier_train_steps"] = 3
    path = tmp_path / ("proj.yaml" if with_projection else "plain.yaml")
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_runs_the_projection_stage_then_skips_it(tmp_path):
    """``self_supervised_pretraining`` on a projection config: two epochs of
    ArcFace steps (finite losses in ``history["projection"]``), the
    stage's convergence marker under ``checkpoints/projection``, the
    bundle with the projection leaves, and a rerun that skips the stage."""
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.train.checkpoint import read_convergence_marker

    path = _tiny_projection_config(tmp_path)
    out = tmp_path / "out"
    r = train_fragment_core(path, str(out), device="cpu",
                            self_supervised_pretraining=True)
    hist = r["history"]["projection"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    marker = read_convergence_marker(out / "checkpoints" / "projection")
    assert marker is not None
    assert (out / "checkpoints" / "projection").is_dir()
    rows = [ln.split(",")[0] for ln in
            open(out / "history.csv").read().splitlines()[1:]]
    assert rows.count("projection") == 2
    before = (out / "params.msgpack").read_bytes()
    cli.main(["train", "-c", path, "-o", str(out), "--device", "cpu",
              "--self-supervised-pretraining"])
    r2 = train_fragment_core(path, str(out), device="cpu",
                             self_supervised_pretraining=True)
    assert "projection" not in r2["history"]
    assert (out / "params.msgpack").read_bytes() == before


def test_pretraining_flag_without_a_projection_section_is_a_no_op(tmp_path):
    """Without ``model.projection`` the flag changes nothing: the same
    bundle bytes and history as a run without it."""
    path = _tiny_projection_config(tmp_path, with_projection=False)
    a = train_fragment_core(path, str(tmp_path / "a"), device="cpu",
                            self_supervised_pretraining=True)
    b = train_fragment_core(path, str(tmp_path / "b"), device="cpu")
    assert "projection" not in a["history"]
    assert a["history"]["classifier"][0]["loss"] == \
        b["history"]["classifier"][0]["loss"]
    assert (tmp_path / "a" / "params.msgpack").read_bytes() == \
        (tmp_path / "b" / "params.msgpack").read_bytes()
    assert not (tmp_path / "a" / "checkpoints" / "projection").exists()


def test_arcface_gradient_at_a_unit_cosine_is_nan_as_in_jax():
    """An embedding parallel (or opposite) to a class centroid gives a
    cosine of exactly +-1, where the clip to +-(1 - 1e-9) is +-1 in f32 and
    ``arccos``' derivative is infinite: both packages give the same finite
    loss and NaN in the same gradient elements (ROADMAP.md, "About the
    reference")."""
    w = np.eye(3, 4, dtype=np.float32)
    emb = np.array([[2, 0, 0, 0], [0, 0, -3, 0]], np.float32)
    lab = np.eye(3, dtype=np.float32)[[0, 1]]
    jarc = jlosses.ArcFaceLoss(num_classes=3, embedding_dim=4)
    want, (g_w, g_e) = jax.value_and_grad(
        lambda p, e: jarc.apply({"params": p}, jnp.asarray(lab), e),
        argnums=(0, 1))({"class_weights": jnp.asarray(w)}, jnp.asarray(emb))
    tarc = tlosses.ArcFaceLoss(3, 4)
    with torch.no_grad():
        tarc.class_weights.copy_(torch.from_numpy(w))
    temb = torch.from_numpy(emb).requires_grad_(True)
    got = tarc(torch.from_numpy(lab), temb)
    got.backward()
    _close(float(got.detach()), float(want), "loss")
    for g, jg in ((tarc.class_weights.grad, g_w["class_weights"]),
                  (temb.grad, g_e)):
        jg = np.asarray(jg)
        assert np.array_equal(np.isnan(g.numpy()), np.isnan(jg))
        assert np.isnan(jg).any()
        fin = np.isfinite(jg)
        if fin.any():
            _close(g.numpy()[fin], jg[fin], "finite elements")
