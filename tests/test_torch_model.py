"""The port's model forward against the JAX model, weights carried across
by ``params_from_jax``.

Two models: the demo bundle (trained weights; masked BN + NMD, two k3
residual blocks, average pool) and the inline flagship (DYT + NMD, three
k5 DYT residual blocks, max pool), JAX-initialized on the CPU and then
given random norms, biases and moving means (numpy, seeded) so that every
parameter matters. Each is compared in the dense, the full masked and
every bounded-cut program.

Tolerances. f32: 1e-5 relative to each output's scale (max |ref|) — the
two sides sum the convolutions in different orders. bf16: 5e-2 of the
output's scale — bf16 keeps 8 mantissa bits, and the JAX model rounds
after every op (conv, bias, each DYT op, activation) where the port's
fused block rounds once, so through ~20 rounded ops the outputs drift by
a few bf16 ulps of their scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jaeger_tpu.models.artifacts import load_model as jax_load_model
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.models.flagship import _inline_flagship
from jaeger_tpu_torch.models.artifacts import (load_model, load_state,
                                               params_from_jax)
from jaeger_tpu_torch.models.builder import build_model, mask_cut_plan

DEMO = "jaeger_tpu/data/models/demo"
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randomize(variables, seed=0):
    """Random values for every non-kernel leaf, so norms, biases and
    moving statistics all shape the outputs."""
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


@pytest.fixture(scope="module")
def flagship():
    cfg = _inline_flagship()
    _, variables = ModelBuilder(cfg).init(batch=1)
    variables = _randomize(jax.tree_util.tree_map(np.asarray, variables))
    return cfg, variables


@pytest.fixture(scope="module")
def demo():
    _, variables, config, _ = jax_load_model(DEMO)
    return config, jax.tree_util.tree_map(np.asarray, variables)


def _inputs(rng, crop, n=4):
    """(dense, masked, bounded) base/length pairs for ``crop``."""
    dense = (rng.integers(0, 4, size=(n, crop)).astype(np.uint8),
             np.full(n, crop, np.int32))
    b = rng.integers(0, 9, size=(n, crop + 5)).astype(np.uint8)
    b[0, 40:80] = 4
    masked = (b, np.array([crop + 5, crop // 2, crop - 7, 30], np.int32))
    b = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    b[:, crop // 3] = 4                      # one interior N per row
    bounded = (b, np.full(n, crop, np.int32))
    return dense, masked, bounded


def _programs(config, crop, rng):
    dense, masked, bounded = _inputs(rng, crop)
    progs = [("dense", dense, {"assume_dense": True}),
             ("masked", masked, {}), ("masked_dense_rows", dense, {})]
    plans = mask_cut_plan(config.get("model", config)[
        "representation_learner"]) or []
    for cut, _, _ in plans:
        progs.append((f"bounded_{cut}", bounded, {"mask_layers": cut}))
    return progs


def _compare(config, variables, dt, rng, torch_model=None):
    jm = ModelBuilder(config, dtype=JDT[dt]).build()
    if torch_model is None:
        torch_model = build_model(config, dtype=TDT[dt])
        load_state(torch_model, params_from_jax(variables))
    torch_model.eval()
    crop = jm.crop_nt
    assert torch_model.crop_nt == crop
    progs = _programs(config, crop, rng)
    assert len(progs) >= 4
    for name, (bases, lengths), kw in progs:
        want = jm.apply(variables, {"bases": jnp.asarray(bases),
                                    "lengths": jnp.asarray(lengths)},
                        train=False, **kw)
        with torch.inference_mode():
            got = torch_model(torch.from_numpy(bases),
                              torch.from_numpy(lengths), **kw)
        assert set(got) == set(want), name
        for key in want:
            a = np.asarray(want[key], np.float32)
            b = got[key].float().numpy()
            assert a.shape == b.shape, (name, key)
            scale = max(float(np.abs(a).max()), 1e-6)
            np.testing.assert_allclose(b, a, rtol=TOL[dt],
                                       atol=TOL[dt] * scale,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flagship_matches_jax(flagship, rng, dt):
    cfg, variables = flagship
    _compare(cfg, variables, dt, rng)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_demo_bundle_matches_jax(demo, rng, dt):
    config, variables = demo
    model, _, classes = load_model(DEMO, dtype=TDT[dt], device="cpu")
    assert classes == {0: "chromosome", 1: "phage", 2: "plasmid"}
    _compare(config, variables, dt, rng, torch_model=model)


def test_bf16_folds_embedding_only(flagship):
    cfg, _ = flagship
    assert build_model(cfg, dtype=torch.bfloat16).can_fold
    assert not build_model(cfg, dtype=torch.float32).can_fold


def test_params_from_jax_names_follow_flax(flagship):
    cfg, variables = flagship
    state = params_from_jax(variables)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(state) == len(flat)
    key = "rep.residual_block_3.block_0.conv1.kernel"
    np.testing.assert_array_equal(
        state[key].numpy(),
        variables["params"]["rep"]["residual_block_3"]["block_0"]["conv1"][
            "kernel"])
    assert tuple(state[key].shape) == (5, 128, 128)     # (k, C_in, C_out)
    assert "rep.nmd_2.moving_mean" in state
