"""The port's Hyena stack against jaeger_tpu's, on the CPU.

Inputs and weights come from numpy seeds; JAX runs on the CPU. Covered:

* the causal long convolution: each route (direct Toeplitz, blocked
  Toeplitz, chunked scan, f32 FFT) against JAX's function of the same
  name at a small chunk (16) and lengths that are not chunk multiples;
  the bf16 dispatch at monkeypatched caps (both packages patched alike);
  the scan route's du and dh against ``jax.vjp``; the gradients of the
  other routes against ``jax.grad``; the scan keeping only ``(u, h)`` for
  its backward;
* ``HyenaFilter``, ``HyenaOperator`` and ``HyenaBlock`` against their JAX
  modules, masked (a fully masked frame included) and unmasked, with
  ``normalize`` and ``out_proj``, f32 and bf16, and the block's gradients;
* ``train_config/hyena_fullcontig.yaml`` at full width and cut narrow
  (dim 16, crop 83 codons, filter FFN 8 wide, dropout 0, as
  ``tests/test_hyena_seq_cli.py`` cuts its model): the parameter tree and
  ``mask_cut_plan``; the forward in every program; one train step per
  program against ``make_train_step``; ``run_core``'s TSV byte-identical
  to JAX's at f32; ``train --device cpu`` writing a bundle (with its int8
  bundle, as JAX's train would) that JAX loads;
* ``model.remat``: with dropout on, one step with remat equals one without
  (the recomputation draws the same dropout masks and does not update the
  batch statistics twice), and both equal JAX's (dropout 0), for Hyena
  blocks and for residual stacks (masked batch norm, and DYT convs on the
  fused kernel's autograd path);
* ``init_params``' Hyena leaves; the quantized bundles' leaves against
  JAX's ``quantize_bundle``; a length-sharded config refused.

Tolerances: f32 to 1e-5 of the scale (sums in another order; the FFT
route is pocketfft in JAX and PyTorch's own FFT here); bf16 outputs
within 2 ulps + 2^-8 of the scale (both packages form the same f32 sums
and round once, ``tests/test_torch_layers_zoo.py``), the Hyena block,
which rounds at several points, within 2e-2 and 2^-6 of the scale as the
attention blocks there; gradients to 5e-5 of each leaf's scale, train
steps as ``tests/test_torch_templates.py``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.models import builder as jbuilder
from jaeger_tpu.models import layers as J
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.utils.config import load_model_config as jax_load_config
from jaeger_tpu_torch.models import layers as T
from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                               params_from_jax, save_model)
from jaeger_tpu_torch.models.builder import build_model, mask_cut_plan
from jaeger_tpu_torch.train import loop as tloop
from jaeger_tpu_torch.train import optimizers as topt
from tests.test_torch_layers_zoo import (DTYPES, _check, _check_grads, _init,
                                         _j, _load, _mask, _t, _x)
from tests.test_torch_templates import (FASTA, _bases, _check_step, _close,
                                        _train_data, _variables)

TEMPLATE = "train_config/hyena_fullcontig.yaml"
CHUNK = 16


def _conv_inputs(seed, length, b=3, d=4, decay=30.0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, d, length)).astype(np.float32)
    h = (rng.standard_normal((d, length))
         * np.exp(-np.arange(length) / decay)).astype(np.float32)
    return u, h


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# --- the causal convolution's routes -----------------------------------------


@pytest.mark.parametrize("length", [1, 37, 83])
def test_toeplitz_route_matches_jax(length):
    u, h = _conv_inputs(length, length)
    want = J._causal_toeplitz_convolve(jnp.asarray(u), jnp.asarray(h))
    got = T._causal_toeplitz_convolve(torch.from_numpy(u),
                                      torch.from_numpy(h))
    _check(got, want, "f32", "direct Toeplitz")


@pytest.mark.parametrize("length", [50, 83])
def test_block_route_matches_jax(length):
    u, h = _conv_inputs(length + 1, length)
    want = J._causal_block_toeplitz_convolve(jnp.asarray(u), jnp.asarray(h),
                                             chunk=CHUNK)
    got = T._causal_block_toeplitz_convolve(torch.from_numpy(u),
                                            torch.from_numpy(h), chunk=CHUNK)
    _check(got, want, "f32", "blocked Toeplitz")


@pytest.mark.parametrize("length", [83, 130])
def test_scan_route_matches_jax(length):
    u, h = _conv_inputs(length + 2, length)
    want = J._causal_chunked_scan_convolve(jnp.asarray(u), jnp.asarray(h),
                                           chunk=CHUNK)
    got = T._causal_chunked_scan_convolve(torch.from_numpy(u),
                                          torch.from_numpy(h), chunk=CHUNK)
    _check(got, want, "f32", "chunked scan")


@pytest.mark.parametrize("length", [1, 83, 700])
def test_fft_route_matches_jax(length):
    """f32 inputs always take the FFT (n = 2L - 1)."""
    u, h = _conv_inputs(length + 3, length, decay=200.0)
    want = J.causal_fft_convolve(jnp.asarray(u), jnp.asarray(h))
    got = T.causal_fft_convolve(torch.from_numpy(u), torch.from_numpy(h))
    assert got.dtype == torch.float32
    _check(got, want, "f32", "FFT")


#: (length, d, expected route) under the caps of ``_small_caps``
DISPATCH_CASES = {
    "direct": (40, 4, "_causal_toeplitz_convolve"),
    "blocked": (70, 4, "_causal_block_toeplitz_convolve"),
    "blocked_by_bytes": (48, 8, "_causal_block_toeplitz_convolve"),
    "scan": (150, 4, "_causal_chunked_scan_convolve"),
    "fft_past_scan": (300, 4, None),
}


def _small_caps(monkeypatch):
    """Caps scaled down in both packages: direct to L 64 and 8 * 48^2 * 4
    - 1 bytes, blocked to L 128, scan to L 256, chunks of 16."""
    for mod in (J, T):
        monkeypatch.setattr(mod, "_DIRECT_CONV_MAX_L", 64)
        monkeypatch.setattr(mod, "_DIRECT_CONV_MAX_BYTES", 8 * 48 * 48 * 4 - 1)
        monkeypatch.setattr(mod, "_BLOCK_CONV_MAX_L", 128)
        monkeypatch.setattr(mod, "_BLOCK_CONV_CHUNK", CHUNK)
        monkeypatch.setattr(mod, "_SCAN_CONV_MAX_L", 256)


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_bf16_dispatch_matches_jax(monkeypatch, case):
    """Both packages send a bf16 input down the same route (the gate on
    operator bytes included) with the same chunk, and agree within bf16
    rounding; the output stays bf16."""
    length, d, route = DISPATCH_CASES[case]
    _small_caps(monkeypatch)
    calls = {J: [], T: []}
    for mod in (J, T):
        for name in ("_causal_toeplitz_convolve",
                     "_causal_block_toeplitz_convolve",
                     "_causal_chunked_scan_convolve"):
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, (
                lambda *a, _n=name, _r=real, _c=calls[mod], **k:
                _c.append((_n, k.get("chunk"))) or _r(*a, **k)))
    u, h = _conv_inputs(length, length, d=d)
    want = J.causal_fft_convolve(_j(u, "bf16"), _j(h, "bf16"))
    got = T.causal_fft_convolve(_t(u, "bf16"), _t(h, "bf16"))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    expect = [] if route is None else [
        (route, None if route == "_causal_toeplitz_convolve" else CHUNK)]
    assert calls[T] == calls[J] == expect
    _check(got, want, "bf16", case)


def test_scan_vjp_matches_jax():
    """The scan's backward (du the flipped forward of the flipped
    gradient, dh the batch-reduced causal correlation) against
    ``jax.vjp`` of ``_causal_chunked_scan_convolve``."""
    u, h = _conv_inputs(9, 83)
    g = np.random.default_rng(10).standard_normal(u.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: J._causal_chunked_scan_convolve(
        a, b, chunk=CHUNK), jnp.asarray(u), jnp.asarray(h))
    du_want, dh_want = vjp(jnp.asarray(g))
    ut = torch.from_numpy(u).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    T._causal_chunked_scan_convolve(ut, ht, chunk=CHUNK).backward(
        torch.from_numpy(g))
    _check(ut.grad, du_want, "f32", "du")
    _check(ht.grad, dh_want, "f32", "dh")


@pytest.mark.parametrize("route", ["direct", "blocked", "fft"])
def test_route_gradients_match_jax(route):
    """Autograd through the direct and blocked routes and the FFT against
    ``jax.grad`` of JAX's function of the same name."""
    fns = {"direct": ("_causal_toeplitz_convolve", {}),
           "blocked": ("_causal_block_toeplitz_convolve", {"chunk": CHUNK}),
           "fft": ("causal_fft_convolve", {})}
    name, kw = fns[route]
    u, h = _conv_inputs(11, 57)
    w = np.random.default_rng(12).standard_normal(u.shape).astype(np.float32)
    gu, gh = jax.grad(lambda a, b: jnp.sum(
        getattr(J, name)(a, b, **kw) * w), argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(h))
    ut = torch.from_numpy(u).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    torch.sum(getattr(T, name)(ut, ht, **kw) * torch.from_numpy(w)).backward()
    _check_grads({"u": ut.grad.numpy(), "h": ht.grad.numpy()},
                 {"u": np.asarray(gu), "h": np.asarray(gh)})


def test_scan_keeps_only_its_inputs_for_backward():
    """The scan's autograd graph holds ``u`` and ``h`` alone; the blocked
    route, differentiated through its loop, holds its operator blocks and
    input slices (about 1.4x the input here, growing with L / chunk)."""
    def saved_bytes(fn):
        held = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: held.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            u = torch.randn(2, 4, 256, requires_grad=True)
            h = torch.randn(4, 256, requires_grad=True)
            fn(u, h, chunk=CHUNK)
        return sum(held)

    inputs = (2 * 4 * 256 + 4 * 256) * 4
    assert saved_bytes(T._causal_chunked_scan_convolve) == inputs
    assert saved_bytes(T._causal_block_toeplitz_convolve) > 2 * inputs


# --- the modules --------------------------------------------------------------


@pytest.mark.parametrize("normalize,order", [(False, 2), (True, 2),
                                             (False, 3)])
def test_hyena_filter_matches_jax(normalize, order):
    """``(order, dim, L)`` f32 filters; one channel's window and FFN are
    zeroed so that ``normalize`` meets a zero norm."""
    length = 83
    jmod = J.HyenaFilter(dim=8, seq_len=length, order=order, hidden_dim=12,
                         normalize=normalize)
    v = _init(jmod, length, seed=3)
    v["params"]["biases"] = np.asarray(v["params"]["biases"])
    v["params"]["biases"][0, 5] = 0.0
    v["params"]["ffn_0_dense_1"]["kernel"] = np.asarray(
        v["params"]["ffn_0_dense_1"]["kernel"]).copy()
    v["params"]["ffn_0_dense_1"]["kernel"][:, 5] = 0.0
    v["params"]["ffn_0_dense_1"]["bias"] = np.asarray(
        v["params"]["ffn_0_dense_1"]["bias"]).copy()
    v["params"]["ffn_0_dense_1"]["bias"][5] = 0.0
    want = jmod.apply(v, length)
    tmod = _load(T.HyenaFilter(8, order=order, hidden_dim=12,
                               normalize=normalize), v)
    got = tmod(length)
    assert got.dtype == torch.float32 and got.shape == (order, 8, length)
    _check(got, want, "f32", "HyenaFilter")
    assert not got[0, 5].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hyena_operator_matches_jax(dtype):
    """``(B, L, C)``: the projections in the compute dtype, the filters in
    f32; f32 takes the FFT, bf16 the direct Toeplitz product."""
    rng = np.random.default_rng(4)
    x = _x(rng, 5, 83, 12)
    jmod = J.HyenaOperator(dim=8, seq_len=83, order=2, filter_hidden=12,
                           dtype=DTYPES[dtype][0])
    v = _init(jmod, _j(x, dtype), seed=5)
    want = jmod.apply(v, _j(x, dtype))
    tmod = _load(T.HyenaOperator(12, 8, order=2, filter_hidden=12,
                                 dtype=DTYPES[dtype][1]), v)
    got = tmod(_t(x, dtype))
    assert got.dtype == DTYPES[dtype][1]
    _check(got, want, dtype, "HyenaOperator")


BLOCK_CASES = [("f32", True, False), ("f32", False, False),
               ("f32", True, True), ("bf16", True, False),
               ("bf16", False, True)]


def _block_pair(dtype, out_proj, dropout=0.0):
    jmod = J.HyenaBlock(dim=16, order=2, filter_hidden=8, dropout=dropout,
                        output_projection=out_proj, filter_normalize=out_proj,
                        dtype=DTYPES[dtype][0])
    tmod = T.HyenaBlock(16, 16, order=2, filter_hidden=8, dropout=dropout,
                        output_projection=out_proj, filter_normalize=out_proj,
                        dtype=DTYPES[dtype][1])
    return jmod, tmod


@pytest.mark.parametrize("dtype,masked,out_proj", BLOCK_CASES)
def test_hyena_block_matches_jax(dtype, masked, out_proj):
    """Eval forward on ``(B, 6, L, C)``; the masked cases hold a frame with
    no valid position, whose output is all zeros. ``out_proj`` cases also
    normalize the filters. bf16 rounds at the projections, the
    convolution's cast, the gate, the residual sum: within 2e-2 and 2^-6
    of the scale, as ``tests/test_torch_layers_zoo.py`` holds the
    attention blocks."""
    rng = np.random.default_rng(6)
    length = 40
    x = _x(rng, 2, 6, length, 16)
    mask = _mask(rng, 2, 6, length) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jmod, tmod = _block_pair(dtype, out_proj)
    v = _init(jmod, _j(x, dtype), jm, seed=7)
    want, wmask = jmod.apply(v, _j(x, dtype), jm)
    _load(tmod, v)
    with torch.inference_mode():
        got, gmask = tmod(_t(x, dtype), None if mask is None
                          else torch.from_numpy(mask))
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "f32":
        _check(got, want, "f32", "HyenaBlock")
    else:
        want32 = _f32(want)
        np.testing.assert_allclose(got.float().numpy(), want32, rtol=2e-2,
                                   atol=2.0 ** -6 * float(
                                       np.abs(want32).max()))
    assert (gmask is None) == (wmask is None)
    if masked:
        assert not got[0, 1].any()
        assert not got[~torch.from_numpy(mask)].any()


def test_hyena_block_gradients_match_jax():
    """Train mode (dropout 0), masked, with ``out_proj``: the gradients of
    a random projection of the output with respect to the input and every
    parameter, to 5e-5 of each leaf's scale."""
    rng = np.random.default_rng(13)
    x = _x(rng, 2, 6, 30, 16)
    mask = _mask(rng, 2, 6, 30)
    proj = _x(rng, 2, 6, 30, 16)
    jmod, tmod = _block_pair("f32", True)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(mask), seed=14)

    def loss(p, xx):
        out, _ = jmod.apply({"params": p}, xx, jnp.asarray(mask), True)
        return jnp.sum(out * proj)

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    _load(tmod, v)
    for p in tmod.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = tmod(xt, torch.from_numpy(mask), train=True,
                  generator=torch.Generator())
    torch.sum(out * torch.from_numpy(proj)).backward()
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(gp)}
    got = {k.replace(".", "/"): p.grad.numpy()
           for k, p in tmod.named_parameters()}
    assert set(got) == set(want)
    want["x"], got["x"] = np.asarray(gx), xt.grad.numpy()
    _check_grads(got, want)


def test_hyena_block_dropout_draws_from_generator():
    """Train-mode dropout is drawn from the caller's generator: the same
    seed gives the same output, another seed another; eval mode has
    none."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(_x(rng, 1, 6, 20, 16))
    _, tmod = _block_pair("f32", False, dropout=0.5)
    load_state(tmod, {k: torch.from_numpy(_x(rng, *v.shape)) * 0.3
                      for k, v in tmod.state_dict().items()})

    def run(seed):
        with torch.no_grad():
            return tmod(x, train=True,
                        generator=torch.Generator().manual_seed(seed))[0]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    with torch.no_grad():
        assert not torch.equal(tmod(x)[0], run(1))


# --- the template ------------------------------------------------------------


def narrow(dropout: float = 0.0) -> dict:
    """The Hyena template cut to dim 16 (embedding 16, filter FFN 8 wide),
    a crop of 83 codons (254 nt) and the given dropout."""
    cfg = jax_load_config(TEMPLATE)
    m = cfg["model"]
    m["embedding"]["embedding_size"] = 16
    m["string_processor"]["crop_size"] = 83
    for entry in m["representation_learner"]["hidden_layers"]:
        entry["config"].update(dim=16, filter_hidden=8, dropout=dropout)
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = narrow()
    return cfg, ModelBuilder(copy.deepcopy(cfg)).build(), _variables(cfg, 21)


def test_template_plan_and_tree_equal_jax():
    """``mask_cut_plan`` (none: a Hyena block is not mask-cut safe) and
    the parameter tree, at the template's own widths and cut narrow."""
    for cfg in (jax_load_config(TEMPLATE), narrow()):
        rep = cfg["model"]["representation_learner"]
        assert mask_cut_plan(rep) == jbuilder.mask_cut_plan(rep) is None
        jv = jax.eval_shape(
            lambda: ModelBuilder(copy.deepcopy(cfg)).init(batch=1)[1])
        want = {"/".join(str(p.key) for p in path[1:]): tuple(v.shape)
                for path, v in jax.tree_util.tree_leaves_with_path(jv)}
        got = {k.replace(".", "/"): tuple(v.shape) for k, v in
               build_model(copy.deepcopy(cfg)).state_dict().items()}
        assert got == want


PROGRAMS = {"dense": {"assume_dense": True}, "masked": {}}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_template_forward_matches_jax(setup, program):
    cfg, jm, variables = setup
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    bases, lengths = _bases(np.random.default_rng(7), tm.crop_nt, program)
    kw = PROGRAMS[program]
    want = jm.apply(variables, {"bases": jnp.asarray(bases),
                                "lengths": jnp.asarray(lengths)}, **kw)
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths), **kw)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], f"{program} {k}")


def _common(cfg, **kw):
    t = cfg["training"]
    return dict(loss_name=t["loss_classifier"],
                loss_params=t["loss_params_classifier"],
                heads=("prediction",), **kw)


def _labelled(rng, crop, program, n_classes=6):
    bases, lengths = _bases(rng, crop, program)
    return {"bases": bases, "lengths": lengths,
            "labels": np.eye(n_classes, dtype=np.float32)[
                rng.integers(0, n_classes, size=6)]}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_template_train_step_matches_jax(setup, program):
    """One classifier step (AdamW with clipnorm, as the template): loss,
    every gradient leaf, the parameters after the step."""
    cfg, jm, variables = setup
    batch = _labelled(np.random.default_rng(11),
                      build_model(copy.deepcopy(cfg)).crop_nt, program)
    _check_step(cfg, jm, variables, batch, _common(cfg, **PROGRAMS[program]),
                float(cfg["training"]["optimizer_params"]["learning_rate"]))


def test_regularized_step_matches_jax():
    """``kernel_regularizer`` on a Hyena block: the port's
    ``regularizer_specs`` are JAX's and reach the block's projection and
    filter kernels (``rep/.*hyena_block_0.*/kernel``); one masked step
    with the penalty equals JAX's."""
    cfg = narrow()
    cfg["model"]["representation_learner"]["hidden_layers"][0][
        "config"].update(kernel_regularizer="l2", kernel_regularizer_w=0.01)
    jm = ModelBuilder(copy.deepcopy(cfg))
    tm = build_model(copy.deepcopy(cfg))
    specs = tm.regularizer_specs()
    assert specs == jm.regularizer_specs() == [
        (r"rep/.*hyena_block_0.*/kernel", "l2", 0.01)]
    variables = _variables(cfg, 25)
    batch = _labelled(np.random.default_rng(16), tm.crop_nt, "masked")
    _check_step(cfg, jm.build(), variables, batch,
                _common(cfg, reg_specs=tuple(specs)),
                float(cfg["training"]["optimizer_params"]["learning_rate"]))


def test_full_width_template_forward_matches_jax():
    """The template at its own widths (dim 32, crop 666 codons): two
    windows, one with an N run, f32."""
    cfg = jax_load_config(TEMPLATE)
    variables = _variables(cfg, 4)
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    bases, lengths = _bases(np.random.default_rng(3), tm.crop_nt, "masked",
                            n=4)
    want = ModelBuilder(copy.deepcopy(cfg)).build().apply(
        variables, {"bases": jnp.asarray(bases),
                    "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _close(got[k].numpy(), want[k], k)


def test_run_core_tsv_byte_identical_to_jax(tmp_path, setup):
    """``run_core`` at f32 with a bundle of the narrow template, windows of
    the model's crop: the TSV equals JAX's byte for byte. JAX runs on one
    device, as the port does: its data-parallel run over the test's eight
    CPU devices shards the batch, which moves its own logits in the last
    f32 bits and rounds one window-score variance of this model to the
    neighbouring float16 value (109.000 against 109.062 on one device)."""
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch.commands.predict import run_core

    cfg, _, variables = setup
    bundle = tmp_path / "hyena_bundle"
    save_model(params_from_jax(variables), cfg, bundle)
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    common = dict(input_path=FASTA, model_path=str(bundle), fsize=crop,
                  stride=crop, batch=512, precision="float32")
    want = jax_run_core(output_dir=str(tmp_path / "jax"), devices=1,
                        **common)
    got = run_core(output_dir=str(tmp_path / "torch"), device="cpu",
                   workers=1, **common)
    assert want.read_bytes().count(b"\n") == 10          # header + 9
    assert got.read_bytes() == want.read_bytes()


def test_train_cli_then_predict(tmp_path):
    """``train --device cpu`` on the narrow template (3 steps) writes the
    bundle and, as JAX's train does for a model whose convs are none, an
    int8 bundle with no int8 conv; ``predict`` runs on it; JAX loads the
    bundle and computes the same outputs."""
    import yaml

    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu.models.conversion import quantize_bundle as jax_quantize
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import load_model

    cfg = narrow(dropout=0.1)
    cfg_path = _train_data(tmp_path, "hyena", cfg)
    out = tmp_path / "run"
    cli.main(["train", "-c", str(cfg_path), "-o", str(out), "--device",
              "cpu"])
    for f in ("params.msgpack", "project.yaml", "classes.yaml",
              "history.csv", "checkpoints/classifier/checkpoints.json",
              "int8/params_int8.msgpack"):
        assert (out / f).exists(), f
    jax_quantize(out, tmp_path / "jax_int8", mode="full_int8")
    scheme = yaml.safe_load((out / "int8" / "quantization.yaml").read_text())
    assert scheme == yaml.safe_load(
        (tmp_path / "jax_int8" / "quantization.yaml").read_text())
    assert scheme["int8_exec_convs"] == 0
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


# --- remat -------------------------------------------------------------------


def _port_step(cfg, variables, batch, common, seed=5):
    """One port step; -> (loss, grads, parameters, statistics, forward
    calls of each remat unit)."""
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(variables))
    calls = []
    for mod in tm.modules():
        if isinstance(mod, (T.HyenaBlock, T.ResidualBlockStack)):
            mod.register_forward_pre_hook(lambda *_: calls.append(1))
    t = cfg["training"]
    state = tloop.TrainState.create(tm, topt.make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    state, met = tloop.make_train_step(tm, tloop.StepConfig(**common))(
        state, tloop.to_device(batch, "cpu"),
        torch.Generator().manual_seed(seed))
    return (float(met["loss"]), state.grads,
            {k: v.clone() for k, v in tm.state_dict().items()}, len(calls))


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_remat_changes_nothing_with_dropout(program):
    """Dropout 0.1 in both blocks: the step with ``model.remat`` (each
    block run again in the backward) gives the same loss, gradients and
    parameters as the step without, and differs from a step with other
    dropout draws."""
    cfg = narrow(dropout=0.1)
    variables = _variables(cfg, 22)
    batch = _labelled(np.random.default_rng(12),
                      build_model(copy.deepcopy(cfg)).crop_nt, program)
    common = _common(cfg, **PROGRAMS[program])
    loss, grads, state, calls = _port_step(cfg, variables, batch, common)
    remat = copy.deepcopy(cfg)
    remat["model"]["remat"] = True
    r_loss, r_grads, r_state, r_calls = _port_step(remat, variables, batch,
                                                   common)
    assert (calls, r_calls) == (2, 4)
    assert r_loss == loss
    for k in grads:
        torch.testing.assert_close(r_grads[k], grads[k], rtol=1e-6,
                                   atol=1e-7, msg=k)
    for k in state:
        torch.testing.assert_close(r_state[k], state[k], rtol=1e-6,
                                   atol=1e-7, msg=k)
    other = _port_step(remat, variables, batch, common, seed=6)[0]
    assert other != loss


def _tiny_bn() -> dict:
    """The residual-stack remat case of ``tests/test_train_dispatch.py``:
    masked batch norms (moving statistics), two blocks."""
    from tests.test_train_dispatch import _tiny_config

    return {"model": _tiny_config(), "training": {
        "optimizer": "sgd", "optimizer_params": {"learning_rate": 0.01},
        "loss_classifier": "categorical_crossentropy",
        "loss_params_classifier": {"from_logits": True}}}


def _narrow_dyt() -> dict:
    """The flagship template cut narrow: DYT residual convs on the fused
    kernel's autograd path (``FusedConvBlockFn``)."""
    from tests.test_torch_train import _narrow_flagship

    return _narrow_flagship()


@pytest.mark.parametrize("name", ["hyena", "residual_bn", "residual_dyt"])
def test_remat_step_matches_jax(name):
    """``model.remat`` in both packages (dropout 0): one masked-program
    step equals JAX's, the batch statistics updated once; the port's
    remat step equals its step without remat."""
    cfg = {"hyena": narrow, "residual_bn": _tiny_bn,
           "residual_dyt": _narrow_dyt}[name]()
    cfg["model"]["remat"] = True
    variables = _variables(cfg, 23)
    n_classes = int(cfg["model"]["classifier_out_dim"])
    rng = np.random.default_rng(14)
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    batch = _labelled(rng, crop, "masked", n_classes)
    common = _common(cfg)
    _check_step(cfg, ModelBuilder(copy.deepcopy(cfg)).build(), variables,
                batch, common,
                float(cfg["training"]["optimizer_params"]["learning_rate"]))
    loss, grads, state, calls = _port_step(cfg, variables, batch, common)
    plain = copy.deepcopy(cfg)
    plain["model"]["remat"] = False
    p_loss, p_grads, p_state, p_calls = _port_step(plain, variables, batch,
                                                   common)
    assert calls == 2 * p_calls > 0
    assert loss == p_loss
    for k in p_grads:
        torch.testing.assert_close(grads[k], p_grads[k], rtol=1e-6,
                                   atol=1e-7, msg=k)
    for k in p_state:
        torch.testing.assert_close(state[k], p_state[k], rtol=1e-6,
                                   atol=1e-7, msg=k)


# --- artifacts ----------------------------------------------------------------


def test_init_params_hyena_distributions():
    """``alphas`` as ``10**U(-3, 0)`` (so no window is constant), biases
    0, the projections lecun-normal, the norm's scale 1."""
    state = init_params(jax_load_config(TEMPLATE),
                        torch.Generator().manual_seed(0))
    for blk in ("rep.hyena_block_0", "rep.hyena_block_1"):
        a = state[f"{blk}.hyena.filter.alphas"]
        assert a.shape == (2, 32)
        assert float(a.min()) >= 1e-3 and float(a.max()) <= 1.0
        logs = torch.log10(a)
        assert float(logs.min()) < -2.5 and float(logs.max()) > -0.5
        assert abs(float(logs.mean()) + 1.5) < 0.3
        assert not state[f"{blk}.hyena.filter.biases"].any()
        k = state[f"{blk}.hyena.proj_0.kernel"]
        assert abs(float(k.std()) - 32 ** -0.5) < 0.2 * 32 ** -0.5
        assert torch.equal(state[f"{blk}.norm.gamma"], torch.ones(32))
    assert not torch.equal(state["rep.hyena_block_0.hyena.filter.alphas"],
                           state["rep.hyena_block_1.hyena.filter.alphas"])


@pytest.mark.parametrize("mode", ["dynamic", "float16", "full_int8"])
def test_quantized_bundles_match_jax(tmp_path, mode):
    """The template's quantized bundles (its widths, the crop cut to 83
    codons) hold JAX's leaves (``proj_*``, the filter FFN's and the
    classifier's kernels where they pass the 1,024-element floor);
    full_int8 has no conv to run int8, as JAX's, and loads and runs as
    float."""
    from jaeger_tpu.models.conversion import quantize_bundle as jax_quantize
    from jaeger_tpu_torch.models.artifacts import (load_model,
                                                   read_flax_msgpack)
    from jaeger_tpu_torch.models.conversion import (int8_conv_count,
                                                    quantize_bundle)

    cfg = jax_load_config(TEMPLATE)
    cfg["model"]["string_processor"]["crop_size"] = 83
    variables = _variables(cfg, 24)
    src = tmp_path / "model"
    save_model(params_from_jax(variables), cfg, src)
    name = "params.msgpack" if mode == "float16" else "params_int8.msgpack"
    want_stats = jax_quantize(src, tmp_path / "jax", mode=mode)
    stats = quantize_bundle(src, tmp_path / "port", mode=mode, device="cpu")
    assert stats.get("int8_exec_convs") == want_stats.get("int8_exec_convs")
    want = read_flax_msgpack(tmp_path / "jax" / name)
    got = read_flax_msgpack(tmp_path / "port" / name)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for p, v in flat_w:
        assert flat_g[p].dtype == v.dtype, p
        np.testing.assert_array_equal(flat_g[p], v, err_msg=str(p))
    if mode != "float16":
        quantized = {"/".join(str(k.key) for k in p[2:-1])
                     for p, _ in flat_w if p[-1].key == "_q"}
        assert "hyena_block_0/hyena/proj_0/kernel" in quantized
    model, _, _ = load_model(tmp_path / "port", device="cpu")
    assert int8_conv_count(model) == 0
    bases, lengths = _bases(np.random.default_rng(5), model.crop_nt,
                            "dense", 2)
    with torch.inference_mode():
        out = model(torch.from_numpy(bases), torch.from_numpy(lengths))
    assert torch.isfinite(out["prediction"]).all()


def test_sequence_sharded_hyena_refused(tmp_path):
    """``model.parallel.seq_axis`` and ``predict --seq-shard`` stay
    refused, naming ROADMAP.md queue 1, item 14."""
    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.commands.train import train_fragment_core

    import yaml

    path = _train_data(tmp_path, "hyena", narrow())
    cfg = yaml.safe_load(path.read_text())
    cfg["model"]["parallel"] = {"seq_axis": "seq"}
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        build_model(copy.deepcopy(cfg))
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        train_fragment_core(str(path), str(tmp_path / "out"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        run_core(FASTA, str(tmp_path / "p"),
                 "jaeger_tpu/data/models/demo", seq_shard=2, device="cpu")
