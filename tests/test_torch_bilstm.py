"""The port's MaskedBiLSTM against jaeger_tpu's, on the CPU.

The same numpy-seeded inputs and weights (the JAX module's parameter tree,
every leaf drawn from a seed, loaded under the same dot-joined names) go
through ``jaeger_tpu.models.layers.MaskedBiLSTM`` and the port's. Masks
hold runs of masked steps inside a row (not only a padded tail), a fully
masked row and a fully valid one. Covered: ``return_sequences`` true and
false, ``ignore_mask``, f32 and bf16, the gradients against ``jax.grad``,
a model with the layer built from a config in every program, one train
step against JAX's, ``init_params``' distributions and the quantized
bundles.

Tolerances: f32 to 1e-5 relative (``tests/test_torch_layers_zoo.py``).
bf16 has ten rounding points a step (the recurrent product, the add, four
gate functions, the cell's two products and sum, the output's tanh and
product), and each step's rounded ``h`` and ``c`` feed the next: XLA and
PyTorch round an element to neighbouring bf16 values at some of them (on
the CPU 44 % of the elements differ at the first step, by one or two
ulps, whatever the order of rounding the port tries), so bf16 is held as
the attention blocks in ``tests/test_torch_layers_zoo.py`` are, at 2e-2
relative and 2^-6 of the scale, and the port's distance to the f32 output
may be at most twice JAX's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.models import layers as J
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu_torch.models import layers as T
from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                               params_from_jax, save_model)
from jaeger_tpu_torch.models.builder import build_model
from tests.test_torch_layers_zoo import (DTYPES, _check, _check_grads, _init,
                                         _j, _load, _t, _x)

B, FR, C, U = 2, 3, 8, 6


def _runs_mask(rng, length):
    """Masked runs inside rows: row 0 of frame 0 fully masked, row 1 of
    frame 2 fully valid, the others with two masked runs each."""
    mask = np.ones((B, FR, length), bool)
    for b in range(B):
        for f in range(FR):
            for _ in range(2):
                lo = int(rng.integers(0, length - 2))
                mask[b, f, lo:lo + int(rng.integers(1, 4))] = False
    mask[0, 0] = False
    mask[1, 2] = True
    return mask


def _pair(return_sequences=True, ignore_mask=False, dtype="f32"):
    jmod = J.MaskedBiLSTM(units=U, return_sequences=return_sequences,
                          ignore_mask=ignore_mask, dtype=DTYPES[dtype][0])
    tmod = T.MaskedBiLSTM(C, U, return_sequences=return_sequences,
                          ignore_mask=ignore_mask, dtype=DTYPES[dtype][1])
    return jmod, tmod


CASES = [(rs, im, dt) for rs in (True, False) for im in (False, True)
         for dt in DTYPES]


@pytest.mark.parametrize("return_sequences,ignore_mask,dtype", CASES)
def test_bilstm_matches_jax(return_sequences, ignore_mask, dtype):
    rng = np.random.default_rng(3)
    length = 12 if dtype == "bf16" else 17
    x = _x(rng, B, FR, length, C)
    mask = _runs_mask(rng, length)
    jmod, tmod = _pair(return_sequences, ignore_mask, dtype)
    v = _init(jmod, _j(x, dtype), jnp.asarray(mask), seed=4)
    want, wmask = jmod.apply(v, _j(x, dtype), jnp.asarray(mask))
    _load(tmod, v)
    got, gmask = tmod(_t(x, dtype), torch.from_numpy(mask))
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "f32":
        _check(got, want, dtype, "masked_bilstm")
    else:
        want32 = np.asarray(jnp.asarray(want, jnp.float32))
        got32 = got.float().numpy()
        scale = float(np.abs(want32).max())
        np.testing.assert_allclose(got32, want32, rtol=2e-2,
                                   atol=2.0 ** -6 * scale)
        exact, _ = _pair(return_sequences, ignore_mask)[0].apply(
            v, jnp.asarray(x), jnp.asarray(mask))
        exact = np.asarray(exact)
        assert (np.abs(got32 - exact).max()
                <= 2 * np.abs(want32 - exact).max())
    assert (gmask is None) == (wmask is None) == ignore_mask
    if not ignore_mask:
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


def test_bilstm_without_mask_matches_jax():
    rng = np.random.default_rng(5)
    x = _x(rng, B, FR, 9, C)
    jmod, tmod = _pair()
    v = _init(jmod, jnp.asarray(x), None, seed=6)
    want, _ = jmod.apply(v, jnp.asarray(x), None)
    got, gmask = _load(tmod, v)(torch.from_numpy(x), None)
    assert gmask is None
    _check(got, want, "f32", "masked_bilstm unmasked")


def test_bilstm_masked_steps_carry_state():
    """A masked step leaves both directions' state unchanged: the forward
    direction's output there repeats the last valid step's, the backward
    direction's the next valid step's, and a fully masked row is zero."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_x(rng, 1, 2, 10, C))
    mask = torch.ones(1, 2, 10, dtype=torch.bool)
    mask[0, 0, 4:7] = False
    mask[0, 1] = False
    tmod = T.MaskedBiLSTM(C, U)
    load_state(tmod, {k: torch.from_numpy(_x(rng, *v.shape))
                      for k, v in tmod.state_dict().items()})
    out, _ = tmod(x, mask)
    fwd, bwd = out[0, 0, :, :U], out[0, 0, :, U:]
    for t in (4, 5, 6):
        torch.testing.assert_close(fwd[t], fwd[3], rtol=0, atol=0)
        torch.testing.assert_close(bwd[t], bwd[7], rtol=0, atol=0)
    assert not out[0, 1].any()


@pytest.mark.parametrize("return_sequences", [True, False])
def test_bilstm_gradients_match_jax(return_sequences):
    """Gradients of a random projection of the output with respect to the
    input and every parameter, masked runs inside the rows, to 5e-5 of
    each leaf's scale."""
    rng = np.random.default_rng(8)
    length = 11
    x = _x(rng, B, FR, length, C)
    mask = _runs_mask(rng, length)
    jmod, tmod = _pair(return_sequences)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(mask), seed=9)
    out_shape = ((B, FR, length, 2 * U) if return_sequences
                 else (B, FR, 2 * U))
    proj = _x(rng, *out_shape)

    def loss(p, xx):
        out, _ = jmod.apply({"params": p}, xx, jnp.asarray(mask), True)
        return jnp.sum(out * proj)

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    _load(tmod, v)
    for p in tmod.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = tmod(xt, torch.from_numpy(mask), train=True)
    torch.sum(out * torch.from_numpy(proj)).backward()
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(gp)}
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    assert set(got) == set(want) == {
        f"{d}_{w}" for d in ("fwd", "bwd")
        for w in ("kernel", "recurrent", "bias")}
    want["x"], got["x"] = np.asarray(gx), xt.grad.numpy()
    _check_grads(got, want)


# --- in a model -------------------------------------------------------------

#: a narrow model with the layer between masked convs and the pooler (in
#: bf16 the first conv takes the folded embedding, which int8 calibration
#: skips in both packages; the second runs int8 in a full_int8 bundle)
BILSTM_CFG = {
    "model": {
        "name": "bilstm_narrow",
        "seed": 5,
        "classifier_out_dim": 3,
        "class_label_map": [{"class": c, "label": i} for i, c in
                            enumerate(("chromosome", "phage", "plasmid"))],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 8},
        "string_processor": {"crop_size": 20, "codon": "CODON"},
        "representation_learner": {
            "hidden_layers": [
                {"name": "masked_conv1d",
                 "config": {"filters": 16, "kernel_size": 3,
                            "padding": "same"}},
                {"name": "gelu"},
                {"name": "masked_conv1d",
                 "config": {"filters": 16, "kernel_size": 3,
                            "padding": "same"}},
                {"name": "masked_bilstm", "config": {"units": 8}},
            ],
            "pooling": "max",
        },
        "classifier": {"hidden_layers": [
            {"name": "dense", "config": {"units": 3}}]},
    },
    "training": {"optimizer": "adamw",
                 "optimizer_params": {"learning_rate": 1e-3,
                                      "weight_decay": 1e-4},
                 "loss_classifier": "categorical_crossentropy",
                 "loss_params_classifier": {"from_logits": True}},
}


def _bilstm_setup(seed=2, units=8, filters=16):
    """(config, JAX model, randomized flax variables)."""
    from tests.test_torch_templates import _variables

    cfg = copy.deepcopy(BILSTM_CFG)
    layers = cfg["model"]["representation_learner"]["hidden_layers"]
    layers[0]["config"]["filters"] = layers[2]["config"]["filters"] = filters
    layers[3]["config"]["units"] = units
    return cfg, ModelBuilder(copy.deepcopy(cfg)).build(), _variables(cfg,
                                                                     seed)


@pytest.mark.parametrize("program", ["dense", "masked"])
def test_bilstm_model_forward_matches_jax(program):
    from tests.test_torch_templates import _bases, _close

    cfg, jm, variables = _bilstm_setup()
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    bases, lengths = _bases(np.random.default_rng(4), tm.crop_nt, program)
    kw = {"assume_dense": True} if program == "dense" else {}
    want = jm.apply(variables, {"bases": jnp.asarray(bases),
                                "lengths": jnp.asarray(lengths)}, **kw)
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths), **kw)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], f"{program} {k}")


def test_bilstm_model_train_step_matches_jax():
    """One classifier step on a masked batch: loss, every gradient leaf,
    the parameters after AdamW (``tests/test_torch_templates.py``)."""
    from tests.test_torch_templates import _bases, _check_step

    cfg, jm, variables = _bilstm_setup()
    rng = np.random.default_rng(6)
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    bases, lengths = _bases(rng, crop, "masked")
    batch = {"bases": bases, "lengths": lengths,
             "labels": np.eye(3, dtype=np.float32)[
                 rng.integers(0, 3, size=6)]}
    t = cfg["training"]
    _check_step(cfg, jm, variables, batch,
                dict(loss_name=t["loss_classifier"],
                     loss_params=t["loss_params_classifier"],
                     heads=("prediction",)),
                t["optimizer_params"]["learning_rate"])


def test_bilstm_bundle_round_trips(tmp_path):
    """``save_model`` then ``load_model`` in both packages: the port's
    bundle of the model loads in JAX and in the port, and both compute
    the port's forward; JAX's bundle loads in the port."""
    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu.models.artifacts import save_model as jax_save_model
    from jaeger_tpu_torch.models.artifacts import load_model
    from tests.test_torch_templates import _bases, _close

    cfg, _, variables = _bilstm_setup(seed=7)
    save_model(params_from_jax(variables), cfg, tmp_path / "port")
    jax_save_model(variables, cfg, tmp_path / "jax")
    tm, _, _ = load_model(tmp_path / "port", device="cpu")
    bases, lengths = _bases(np.random.default_rng(8), tm.crop_nt, "masked")
    with torch.inference_mode():
        want = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
        again = load_model(tmp_path / "jax", device="cpu")[0](
            torch.from_numpy(bases), torch.from_numpy(lengths))
    jm, jvars, _, _ = jax_load_model(tmp_path / "port")
    got = jm.apply(jvars, {"bases": jnp.asarray(bases),
                           "lengths": jnp.asarray(lengths)})
    for k in want:
        _close(np.asarray(got[k]), want[k].numpy(), f"JAX loads {k}")
        torch.testing.assert_close(again[k], want[k], rtol=0, atol=0)


def test_init_params_bilstm_distributions():
    """Input kernels glorot-uniform, recurrent kernels orthogonal (rows
    orthonormal for ``(U, 4U)``), biases zero but the forget slice
    ``[U:2U]`` at 1, as Keras and the JAX layer initialize them."""
    cfg = _bilstm_setup(units=32)[0]
    state = init_params(cfg, torch.Generator().manual_seed(1))
    for d in ("fwd", "bwd"):
        k = state[f"rep.masked_bilstm_3.{d}_kernel"]
        lim = np.sqrt(6.0 / (16 + 128))
        assert k.shape == (16, 128) and float(k.abs().max()) <= lim
        assert float(k.abs().max()) > 0.9 * lim
        assert abs(float(k.std()) - lim / np.sqrt(3)) < 0.1 * lim
        r = state[f"rep.masked_bilstm_3.{d}_recurrent"]
        torch.testing.assert_close(r @ r.T, torch.eye(32), rtol=0,
                                   atol=1e-5)
        bias = state[f"rep.masked_bilstm_3.{d}_bias"]
        want = torch.zeros(128)
        want[32:64] = 1.0
        torch.testing.assert_close(bias, want, rtol=0, atol=0)
    assert not torch.equal(state["rep.masked_bilstm_3.fwd_recurrent"],
                           state["rep.masked_bilstm_3.bwd_recurrent"])


@pytest.mark.parametrize("mode", ["dynamic", "float16", "full_int8"])
def test_bilstm_quantized_bundles_match_jax(tmp_path, mode):
    """The port's ``quantize_bundle`` holds the same leaves as JAX's for a
    model with the layer (at 32 channels and 32 units its input and
    recurrent kernels pass the 1,024-element floor of ``dynamic``); in
    ``full_int8`` the second masked conv runs int8 and the BiLSTM in float,
    and the port's forward of the bundle equals JAX's."""
    from jaeger_tpu.models.conversion import load_quantized as jax_load_q
    from jaeger_tpu.models.conversion import quantize_bundle as jax_quantize
    from jaeger_tpu_torch.models.artifacts import (load_model,
                                                   read_flax_msgpack)
    from jaeger_tpu_torch.models.conversion import (int8_conv_count,
                                                    quantize_bundle)
    from tests.test_torch_templates import _bases, _close

    cfg, _, variables = _bilstm_setup(seed=3, units=32, filters=32)
    src = tmp_path / "model"
    save_model(params_from_jax(variables), cfg, src)
    name = "params.msgpack" if mode == "float16" else "params_int8.msgpack"
    jax_quantize(src, tmp_path / "jax", mode=mode)
    stats = quantize_bundle(src, tmp_path / "port", mode=mode, device="cpu")
    want = read_flax_msgpack(tmp_path / "jax" / name)
    got = read_flax_msgpack(tmp_path / "port" / name)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    quantized = {"/".join(str(k.key) for k in p[:-1]) for p, _ in flat_w
                 if p[-1].key == "_q"}
    if mode != "float16":
        assert {q for q in quantized if "bilstm" in q} == {
            f"params/rep/masked_bilstm_3/{d}_{w}"
            for d in ("fwd", "bwd") for w in ("recurrent", "kernel")}
    for p, v in flat_w:
        assert flat_g[p].dtype == v.dtype, p
        if p[-1].key == "act_scale":
            np.testing.assert_allclose(flat_g[p], v, rtol=1e-2)
        else:
            np.testing.assert_array_equal(flat_g[p], v, err_msg=str(p))
    if mode != "full_int8":
        return
    assert stats["int8_exec_convs"] == 1
    jm, jvars, config, _ = jax_load_q(tmp_path / "port")
    model, _, _ = load_model(tmp_path / "port", device="cpu")
    assert int8_conv_count(model) == 1
    bases, lengths = _bases(np.random.default_rng(2), model.crop_nt,
                            "masked")
    want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                            "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = model(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _close(got[k].numpy(), want[k], f"full_int8 {k}")
