"""The port's layer zoo against jaeger_tpu's layers, on the CPU.

Each layer the templates' slice adds (nucleotide encoding, the norms, the
poolers, the multi-scale conv, the OOD signals, the positional
embeddings and the attention family) runs on the same numpy-seeded input
and weights as its JAX module, masked and unmasked. The weights are the
JAX module's parameter tree with every leaf drawn from a seed, loaded into
the port's module under the same (dot-joined) names.

Tolerances, and why:
* f32: 1e-5 relative, with an absolute floor of 1e-5 of the output's
  largest magnitude (f32 sums in another order);
* bf16: the port computes in bf16 at the places JAX does and rounds the
  same f32 sums once, but XLA and PyTorch evaluate exp, tanh, rsqrt and
  the bf16 matmuls' accumulations in their own orders, so an element may
  round to a neighbouring bf16 value at each rounding point it passes:
  within 2 bf16 ulps (2^-7 relative) of each element plus 2^-8 of the
  output's scale, except where noted;
* the attention layers' masks: a row whose keys are all invalid gets
  JAX's uniform weights (finite), never NaN; the masked rows of every
  case include one such row.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.models import builder as jbuilder
from jaeger_tpu.models import layers as J
from jaeger_tpu.ops import encode as jencode
from jaeger_tpu_torch.models import builder as tbuilder
from jaeger_tpu_torch.models import layers as T
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.ops import encode as tencode

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, FR, L, C = 2, 6, 24, 16


def _mask(rng, b=B, f=FR, length=L):
    """A valid prefix per frame, one frame fully masked, one fully valid."""
    lens = rng.integers(1, length, size=(b, f))
    lens[0, 1] = 0
    lens[1, 2] = length
    return np.arange(length)[None, None, :] < lens[..., None]


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _random_tree(tree, seed):
    """Every leaf of a flax variable tree drawn from ``seed``: kernels
    around their init scale, scales near 1, the rest around 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name in ("gamma", "moving_variance", "alpha"):
            return (0.7 + 0.6 * rng.random(shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) or 1
            if path[-2].key in ("out",):
                fan_in = int(np.prod(shape[:2]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (0.3 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _init(jmod, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args, **kw))
    return _random_tree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), seed)


def _load(tmod, variables):
    state = params_from_jax(dict(variables))
    load_state(tmod, state)
    return tmod


def _check(got, want, dtype, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-6)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=what)
        return
    bound = 2 * 2.0 ** -7 * np.maximum(np.abs(want), np.abs(got)) \
        + 2.0 ** -8 * scale
    err = np.abs(got - want)
    assert (err <= bound).all(), (
        f"{what}: worst {float((err - bound).max()):.3g} beyond")


def _t(a, dtype="f32"):
    t = torch.from_numpy(np.asarray(a))
    return t.to(DTYPES[dtype][1]) if t.is_floating_point() else t


def _j(a, dtype="f32"):
    a = jnp.asarray(a)
    return a.astype(DTYPES[dtype][0]) if jnp.issubdtype(
        a.dtype, jnp.floating) else a


# --- encoding ---------------------------------------------------------------


@pytest.mark.parametrize("masking", [False, True])
@pytest.mark.parametrize("crop", [96, 100])
def test_encode_nucleotide_matches_jax(masking, crop):
    """Both strands one-hot in A, G, C, T order: soft-masked bases fold to
    their base (or mask), N, padding and empty windows are zero rows."""
    rng = np.random.default_rng(crop)
    bases = rng.integers(0, 9, size=(6, 100)).astype(np.uint8)
    lengths = np.array([100, 37, 0, 99, 1, 250], np.int32)
    want = jencode.encode_nucleotide(jnp.asarray(bases), jnp.asarray(lengths),
                                     crop_size=crop, masking=masking)
    got = tencode.encode_nucleotide(torch.from_numpy(bases),
                                    torch.from_numpy(lengths), crop, masking)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- norms --------------------------------------------------------------------


NORM_CASES = [(n, d, m) for n in ("masked_layernorm", "layernorm")
              for d in DTYPES for m in (True, False)]


@pytest.mark.parametrize("norm,dtype,masked", NORM_CASES)
def test_layer_norms_match_jax(norm, dtype, masked):
    rng = np.random.default_rng(1)
    x = _x(rng, B, FR, L, C) * 3 + 1
    mask = _mask(rng) if masked else None
    jmod = J.MaskedLayerNorm(dtype=DTYPES[dtype][0]) if norm.startswith(
        "masked") else J.LayerNorm(dtype=DTYPES[dtype][0])
    jm = None if mask is None else jnp.asarray(mask)
    v = _init(jmod, _j(x, dtype), jm)
    want, wmask = jmod.apply(v, _j(x, dtype), jm)
    tmod = _load(T._make_norm(norm, C), v)
    got, gmask = tmod(_t(x, dtype), None if mask is None
                      else torch.from_numpy(mask))
    assert got.dtype == DTYPES[dtype][1]
    _check(got, want, dtype, norm)
    if masked and norm.startswith("masked"):
        assert not got[~torch.from_numpy(mask)].any()


def test_make_norm_names_match_jax():
    for name in ("masked_batchnorm", "masked_layernorm", "masked_dyt",
                 "layernorm", "layer_normalization"):
        jcls = type(J._make_norm(name, "n"))
        assert type(T._make_norm(name, C)).__name__ == jcls.__name__
    with pytest.raises(ValueError, match="unsupported norm_type"):
        T._make_norm("groupnorm", C)


# --- convs and poolers ------------------------------------------------------


MSC_BRANCHES = ({"filters": 8, "kernel_size": 3},
                {"filters": 8, "kernel_size": 5, "dilation_rate": 2},
                {"filters": 8, "kernel_size": 1, "activation": "relu"})


@pytest.mark.parametrize("merge,masked,dtype", [
    ("concat", True, "f32"), ("concat", False, "f32"), ("add", True, "f32"),
    ("add", False, "f32"), ("concat", True, "bf16")])
def test_multi_scale_conv_matches_jax(merge, masked, dtype):
    rng = np.random.default_rng(2)
    x = _x(rng, B, FR, L, C)
    mask = _mask(rng) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jmod = J.MultiScaleConv1D(branches=MSC_BRANCHES, merge=merge,
                              dtype=DTYPES[dtype][0])
    v = _init(jmod, _j(x, dtype), jm)
    want, wmask = jmod.apply(v, _j(x, dtype), jm)
    tmod = _load(T.MultiScaleConv1D(C, MSC_BRANCHES, merge=merge,
                                    dtype=DTYPES[dtype][1]), v)
    got, gmask = tmod(_t(x, dtype), None if mask is None
                      else torch.from_numpy(mask))
    _check(got, want, dtype, "multi_scale_conv")
    assert (gmask is None) == (wmask is None)
    if masked:
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("padding,masked", [
    ("valid", True), ("valid", False), ("same", True), ("same", False)])
def test_masked_max_pooling_matches_jax(padding, masked):
    rng = np.random.default_rng(3)
    x = _x(rng, B, FR, L + 1, C)
    mask = _mask(rng, length=L + 1) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, wmask = J.MaskedMaxPooling1D(pool_size=3, strides=2,
                                       padding=padding).apply({}, x, jm)
    got, gmask = T.MaskedMaxPooling1D(3, 2, padding)(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if masked:
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("masked,dtype", [(True, "f32"), (False, "f32"),
                                          (True, "bf16")])
def test_last_pooling_matches_jax(masked, dtype):
    rng = np.random.default_rng(4)
    x = _x(rng, B, FR, L, C)
    mask = _mask(rng) if masked else None
    mask_all = None if mask is None else mask.copy()
    if masked:
        mask_all[1] = False                       # an example with no frame
    jm = None if mask is None else jnp.asarray(mask_all)
    want, _ = J.MaskedLastPooling().apply({}, _j(x, dtype), jm)
    got, _ = T.POOLERS["masked_last"](_t(x, dtype), None if mask is None
                                      else torch.from_numpy(mask_all))
    _check(got, want, dtype, "last pooling")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gated_frame_pooling_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = _x(rng, B, FR, L, C)
    jmod = J.GatedFrameGlobalMaxPooling(return_gate=True,
                                        dtype=DTYPES[dtype][0])
    v = _init(jmod, _j(x, dtype), None)
    want, wgate = jmod.apply(v, _j(x, dtype), None)
    tmod = _load(T.GatedFrameGlobalMaxPooling(C, dtype=DTYPES[dtype][1]), v)
    got, gate = tmod(_t(x, dtype))
    _check(got, want, dtype, "gated pooling")
    _check(gate, wgate, dtype, "gates")


def test_poolers_table_matches_jax():
    assert set(T.POOLERS) == set(J.POOLERS)


# --- OOD signals and positional embeddings ----------------------------------


def test_ood_signals_match_jax():
    rng = np.random.default_rng(6)
    logits = _x(rng, 8, 5) * 3
    nmd = _x(rng, 8, 12)
    signals = ("max_prob", "entropy", "energy", "margin", "nmd_norm")
    want = J.OODSignalLayer(signals=signals).apply(
        {}, jnp.asarray(logits, jnp.bfloat16), jnp.asarray(nmd))
    got = T.OODSignalLayer(signals)(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(nmd))
    assert got.dtype == torch.float32
    _check(got, want, "f32", "signals")
    with pytest.raises(ValueError, match="requires an NMD"):
        T.OODSignalLayer(("nmd_norm",))(torch.from_numpy(logits))
    with pytest.raises(ValueError, match="unsupported signal"):
        T.OODSignalLayer(("logit",))(torch.from_numpy(logits))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_positional_embedding_matches_jax(dtype):
    """sin on even channels, cos on odd, f32 then cast: within 1e-5 of the
    scale in f32 (the angles reach 500 rad, so an ulp of a timescale moves
    the sine by 3e-5 at most; measured 1e-6)."""
    x = np.zeros((2, 6, 500, 20), np.float32)
    want = J.SinusoidalPositionEmbedding(max_wavelength=1000.0).apply(
        {}, _j(x, dtype))
    got = T.SinusoidalPositionEmbedding(1000.0)(_t(x, dtype))
    assert got.dtype == DTYPES[dtype][1]
    _check(got, want, dtype, "positional embedding")


def test_sin_pe_matches_jax():
    np.testing.assert_allclose(T.sin_pe(300, 16).numpy(),
                               np.asarray(J._sin_pe(300, 16)), rtol=1e-5,
                               atol=1e-5)


# --- attention ----------------------------------------------------------------


@pytest.mark.parametrize("seq,masked,dtype", [
    (s, m, d) for s in (6, 40) for m in (True, False) for d in DTYPES])
def test_mha_matches_jax(seq, masked, dtype):
    """Both forms (a sequence of 16 or less accumulates in f32), key masks
    with a row of no valid key: JAX's uniform weights, not NaN."""
    rng = np.random.default_rng(seq)
    n = 4
    x = _x(rng, n, seq, C)
    mask = None
    if masked:
        mask = np.arange(seq)[None, :] < np.array([0, 1, seq // 2, seq])[
            :, None]
    jmask = None if mask is None else jnp.asarray(mask[:, None, None, :])
    jmod = J._MHA(embed_dim=C, num_heads=4, dtype=DTYPES[dtype][0])
    v = _init(jmod, _j(x, dtype), jmask)
    want = jmod.apply(v, _j(x, dtype), jmask)
    tmod = _load(T.MHA(C, C, 4, dtype=DTYPES[dtype][1]), v)
    got = tmod(_t(x, dtype), None if mask is None
               else torch.from_numpy(mask[:, None, None, :]))
    assert got.dtype == DTYPES[dtype][1]
    _check(got, want, dtype, "mha")
    if masked:
        # no valid key: every query attends uniformly to all values
        v0 = tmod.value(_t(x, dtype)[:1]).float().mean(dim=1)
        uniform = tmod.out(v0[:, None].to(DTYPES[dtype][1]))[0, 0]
        _check(got[0, 0], np.asarray(uniform.float()), dtype, "uniform row")


def _attention_layers(dtype):
    jd, td = DTYPES[dtype]
    kw = dict(embed_dim=C, num_heads=4, feed_forward_dim=32,
              dropout_rate=0.0)
    targs = (C, C, 4, 32)
    return {
        "transformer": (J.TransformerEncoder(**kw, dtype=jd),
                        T.TransformerEncoder(*targs, 0.0, dtype=td)),
        "crossframe": (J.CrossFrameAttention(**kw, dtype=jd),
                       T.CrossFrameAttention(*targs, 0.0, dtype=td)),
        "crossframe_noffn": (
            J.CrossFrameAttention(**kw, use_ffn=False, dtype=jd),
            T.CrossFrameAttention(*targs, 0.0, use_ffn=False, dtype=td)),
        "axial_layernorm": (
            J.AxialAttention(**kw, num_blocks=2, dtype=jd),
            T.AxialAttention(*targs, 0.0, num_blocks=2, dtype=td)),
        "axial_masked_layernorm": (
            J.AxialAttention(**kw, norm_type="masked_layernorm", dtype=jd),
            T.AxialAttention(*targs, 0.0, norm_type="masked_layernorm",
                             dtype=td)),
        "axial_masked_dyt": (
            J.AxialAttention(**kw, norm_type="masked_dyt", dtype=jd),
            T.AxialAttention(*targs, 0.0, norm_type="masked_dyt", dtype=td)),
        "axial_masked_batchnorm": (
            J.AxialAttention(**kw, norm_type="masked_batchnorm", dtype=jd),
            T.AxialAttention(*targs, 0.0, norm_type="masked_batchnorm",
                             dtype=td)),
        "local": (J.LocalAttention(**kw, window_size=7, num_blocks=2,
                                   dtype=jd),
                  T.LocalAttention(*targs, window_size=7, dropout_rate=0.0,
                                   num_blocks=2, dtype=td)),
    }


ATTN_CASES = (
    [(n, "f32", m) for n in _attention_layers("f32") for m in (True, False)]
    + [(n, "bf16", True) for n in ("transformer", "crossframe",
                                   "axial_layernorm", "local")])


@pytest.mark.parametrize("name,dtype,masked", ATTN_CASES)
def test_attention_layers_match_jax(name, dtype, masked):
    """Eval forward of each attention layer on (B, 6, L, C); the masked
    cases hold a frame with no valid position. bf16 passes two LayerNorms,
    four projections, the softmax and the FFN per block: within 2 ulps of
    each element plus 2^-8 of the scale, the bound of one rounding point,
    holds for all but the blocks' residual sums, where cancellation can
    leave an element of a few ulps; held at 2^-6 of the scale."""
    jmod, tmod = _attention_layers(dtype)[name]
    rng = np.random.default_rng(len(name))
    x = _x(rng, B, FR, L, C)
    mask = _mask(rng) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    v = _init(jmod, _j(x, dtype), jm)
    want, wmask = jmod.apply(v, _j(x, dtype), jm)
    _load(tmod, v)
    with torch.inference_mode():
        got, gmask = tmod(_t(x, dtype), None if mask is None
                          else torch.from_numpy(mask))
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "f32":
        _check(got, want, "f32", name)
    else:
        want32 = np.asarray(jnp.asarray(want, jnp.float32))
        scale = float(np.abs(want32).max())
        np.testing.assert_allclose(got.float().numpy(), want32, rtol=2e-2,
                                   atol=2.0 ** -6 * scale, err_msg=name)
    assert (gmask is None) == (wmask is None)


@pytest.mark.parametrize("name", ["transformer", "crossframe",
                                  "axial_masked_batchnorm", "local"])
def test_attention_gradients_match_jax(name):
    """Train mode (batch statistics where the layer has them), masked:
    the gradients of a random projection of the output with respect to the
    input and every parameter, to 5e-5 of each leaf's scale."""
    jmod, tmod = _attention_layers("f32")[name]
    rng = np.random.default_rng(11)
    x = _x(rng, B, FR, L, C)
    mask = _mask(rng)
    proj = _x(rng, B, FR, L, C)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(mask))
    params = v["params"]
    rest = {k: val for k, val in v.items() if k != "params"}

    def loss(p, xx):
        out, _ = jmod.apply({"params": p, **rest}, xx, jnp.asarray(mask),
                            True, mutable=list(rest))[0]
        return jnp.sum(out * proj)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    _load(tmod, v)
    for p in tmod.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = tmod(xt, torch.from_numpy(mask), train=True)
    torch.sum(out * torch.from_numpy(proj)).backward()
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(gp)}
    got = {k.replace(".", "/"): p.grad.numpy()
           for k, p in tmod.named_parameters()}
    assert set(got) == set(want)
    want["x"], got["x"] = np.asarray(gx), xt.grad.numpy()
    _check_grads(got, want)


def _check_grads(got: dict, want: dict, like: dict | None = None) -> None:
    """Each gradient leaf to 5e-5 of its largest magnitude; a leaf whose
    largest magnitude is below 1e-4 of the largest of any leaf has an exact
    gradient of zero (the key projection's bias: a constant added to every
    score of a row, which the softmax removes) and holds rounding noise on
    both sides, so it is held at 5e-5 of the largest of any leaf, as in
    tests/test_torch_train.py. ``like`` maps a leaf to the leaf whose scale
    it is held at: a sum that cancels to a small fraction of its terms is
    held at the size of those terms (see the zoo train step)."""
    overall = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        scale = max(float(np.abs(want[(like or {}).get(k, k)]).max()), 1e-6)
        if scale < 1e-4 * overall:
            scale = overall
        np.testing.assert_allclose(got[k], want[k], rtol=5e-5,
                                   atol=5e-5 * scale, err_msg=k)


def test_attention_dropout_draws_from_generator():
    """Train-mode dropout (attention weights, the attention output and the
    FFN) draws from the caller's generator: the same seed gives the same
    output, another seed another one, rate 0 the eval output."""
    torch.manual_seed(0)
    layer = T.TransformerEncoder(C, C, 4, 32, dropout_rate=0.3)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(B, FR, L, C)

    def run(seed):
        return layer(x, None, train=True,
                     generator=torch.Generator().manual_seed(seed))[0]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    layer.dropout_rate = layer.mha.dropout_rate = 0.0
    torch.testing.assert_close(run(1), layer(x)[0], rtol=0, atol=0)


# --- builder: the zoo config ------------------------------------------------


def zoo_config(merge: str = "concat") -> dict:
    """A narrow model that uses every layer of the zoo no template uses:
    positional embeddings, a multi-scale conv, masked layer norm, a
    transformer encoder, local attention, parallel branches, gated
    pooling, and reliability mode ``nmd_plus_signals``."""
    return {"model": {
        "classifier_out_dim": 3,
        "embedding": {"use_embedding_layer": True, "input_type": "translated",
                      "embedding_size": 16,
                      "use_positional_embeddings": True},
        "string_processor": {"crop_size": 30, "codon": "CODON"},
        "representation_learner": {
            "hidden_layers": [
                {"name": "multi_scale_conv", "config": {
                    "branches": [{"filters": 8, "kernel_size": 3},
                                 {"filters": 8, "kernel_size": 5}]}},
                {"name": "masked_layernorm"},
                {"name": "nmd"},
                {"name": "transformer_encoder", "config": {
                    "embed_dim": 16, "num_heads": 2, "feed_forward_dim": 24,
                    "dropout_rate": 0.0}},
                {"name": "local_attention", "config": {
                    "embed_dim": 16, "num_heads": 4, "feed_forward_dim": 24,
                    "window_size": 5, "dropout_rate": 0.0}},
                {"name": "parallel_branches", "config": {
                    "merge": merge, "branches": [
                        {"hidden_layers": [
                            {"name": "masked_conv1d", "config": {
                                "filters": 16, "kernel_size": 3,
                                "padding": "same"}},
                            {"name": "nmd"}]},
                        {"hidden_layers": [
                            {"name": "layernorm"},
                            {"name": "dense", "config": {"units": 16}}]}]}},
                {"name": "gelu"},
            ],
            "pooling": "gatedframe"},
        "reliability_model": {
            "mode": "nmd_plus_signals",
            "hidden_layers": [{"name": "dense", "config": {"units": 4}},
                              {"name": "gelu"},
                              {"name": "dense", "config": {"units": 1}}]},
        "classifier": {"hidden_layers": [{"name": "dense",
                                          "config": {"units": 3}}]},
    }, "training": {"optimizer": "adam",
                    "optimizer_params": {"learning_rate": 1e-3},
                    "loss_classifier": "categorical_crossentropy",
                    "loss_params_classifier": {"from_logits": True}}}


def _zoo_models(cfg, seed=0):
    import copy

    jb = jbuilder.ModelBuilder(copy.deepcopy(cfg))
    jm = jb.build()
    v = _random_tree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: jb.init(batch=1)[1])), seed)
    tm = tbuilder.build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(dict(v)))
    return jm, v, tm


def _zoo_inputs(crop, n=4):
    rng = np.random.default_rng(8)
    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.array([crop, crop // 2, 0, crop], np.int32)[:n]
    bases[0, 10:30] = 4
    return bases, lengths


@pytest.mark.parametrize("merge,dense", [("concat", False),
                                         ("concat", True), ("sum", False),
                                         ("average", False), ("max", False)])
def test_zoo_model_forward_matches_jax(merge, dense):
    jm, v, tm = _zoo_models(zoo_config(merge))
    bases, lengths = _zoo_inputs(tm.crop_nt)
    want = jm.apply(v, {"bases": jnp.asarray(bases),
                        "lengths": jnp.asarray(lengths)}, assume_dense=dense)
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths),
                 assume_dense=dense)
    assert set(got) == set(want) == {"embedding", "nmd", "gate",
                                     "prediction", "reliability"}
    for k in want:
        _check(got[k], want[k], "f32", k)


def test_zoo_reliability_head_runs_the_classifier():
    """``nmd_plus_signals`` reads the logits: a reliability-only forward
    still runs the classifier, as JAX's ``_need_pred`` does."""
    jm, v, tm = _zoo_models(zoo_config())
    bases, lengths = _zoo_inputs(tm.crop_nt)
    want = jm.apply(v, {"bases": jnp.asarray(bases),
                        "lengths": jnp.asarray(lengths)},
                    heads=("reliability",))
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths),
                 heads=("reliability",))
    assert set(got) == set(want)
    _check(got["reliability"], want["reliability"], "f32")


def test_zoo_train_step_matches_jax():
    """One classifier step of the zoo model (dropout 0): loss and every
    gradient leaf to 5e-5 of its scale (``_check_grads``), the NMD moving
    means to 1e-5."""
    import optax

    from jaeger_tpu.train import loop as jloop
    from jaeger_tpu.train import optimizers as jopt
    from jaeger_tpu_torch.train import loop as tloop
    from jaeger_tpu_torch.train import optimizers as topt

    cfg = zoo_config()
    jm, v, tm = _zoo_models(cfg)
    bases, lengths = _zoo_inputs(tm.crop_nt)
    labels = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    batch = {"bases": bases, "lengths": lengths, "labels": labels}
    t = cfg["training"]
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    state = jloop.TrainState.create(dict(v), optax.chain(
        capture, jopt.make_optimizer(t["optimizer"], t["optimizer_params"])))
    common = dict(loss_name=t["loss_classifier"],
                  loss_params=t["loss_params_classifier"])
    new_state, jmet = jax.jit(jloop.make_train_step(
        jm, jloop.StepConfig(**common)))(
        state, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(0))
    tstate = tloop.TrainState.create(tm, topt.make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    tstate, tmet = tloop.make_train_step(tm, tloop.StepConfig(**common))(
        tstate, tloop.to_device(batch, "cpu"))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    jg = {"/".join(str(k.key) for k in path): np.asarray(g)
          for path, g in jax.tree_util.tree_leaves_with_path(
              new_state.opt_state[0])}
    assert set(tstate.grads) == set(jg)
    # the gate bias shifts every frame's gate logit alike; the gates are
    # normalized over the frames, so its gradient is a sum over frames
    # that cancels to a few percent of its terms (7e-4 against the gate
    # kernel's 1.4e-2 here; the terms are the kernel's without the
    # features): held at the kernel's scale
    gate = "rep/global_gatedframepool/gate"
    _check_grads({k: g.numpy() for k, g in tstate.grads.items()}, jg,
                 like={f"{gate}/bias": f"{gate}/kernel"})
    want_stats = {"/".join(str(k.key) for k in path): np.asarray(s)
                  for path, s in jax.tree_util.tree_leaves_with_path(
                      new_state.batch_stats)}
    for k, s in tm.state_dict().items():
        if "moving" in k:
            np.testing.assert_allclose(s.numpy(),
                                       want_stats[k.replace(".", "/")],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_both_input_type_matches_jax():
    """``input_type: both`` computes the translated path (JAX encodes the
    nucleotide features as well but no layer reads them)."""
    cfg = zoo_config()
    m = cfg["model"]
    m["embedding"].update(input_type="both", use_positional_embeddings=False)
    m["string_processor"]["nucleotide_crop"] = 60
    jm, v, tm = _zoo_models(cfg, seed=3)
    bases, lengths = _zoo_inputs(tm.crop_nt)
    want = jm.apply(v, {"bases": jnp.asarray(bases),
                        "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _check(got[k], want[k], "f32", k)


@pytest.mark.parametrize("method", ["sum", "max", "concat"])
def test_branched_classifier_merges_match_jax(method):
    """The dvf layout (a shared-weight branch per strand, a shared head per
    branch) with each merge of the head's logits, f32, masked."""
    cfg = {"model": {
        "classifier_out_dim": 3,
        "embedding": {"use_embedding_layer": False,
                      "input_type": "nucleotide"},
        "string_processor": {"crop_size": 60},
        "representation_learner": {"branch": {
            "hidden_layers": [
                {"name": "conv1d", "config": {"filters": 12,
                                              "kernel_size": 10}},
                {"name": "relu"},
                {"name": "masked_conv1d", "config": {"filters": 8,
                                                     "kernel_size": 3}}],
            "pooling": "max1d"}},
        "classifier": {"branch": {"hidden_layers": [
            {"name": "dense", "config": {"units": 6}}, {"name": "relu"},
            {"name": "dense", "config": {"units": 3}},
            {"name": "merge", "config": {"method": method}}]}},
    }}
    jm, v, tm = _zoo_models(cfg, seed=5)
    bases, lengths = _zoo_inputs(60)
    want = jm.apply(v, {"bases": jnp.asarray(bases),
                        "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _check(got[k], want[k], "f32", k)
