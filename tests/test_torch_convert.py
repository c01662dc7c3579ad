"""The port's ``utils convert-weights`` and ``utils convert-graph`` against
`jaeger_tpu`, on the CPU.

* ``convert-weights --family wres -i WRes_1024.h5``: ``params.msgpack``
  and ``legacy.yaml`` byte-identical to those JAX's command writes (run
  through click's ``CliRunner``); the weights load in both packages;
* ``convert-weights --family modern -c``: on the Keras-3 fixture of
  ``tests/test_modern_convert.py`` and on a narrow flagship (three
  same-shaped residual convs, so the creation-order tie-break decides)
  written in the Keras-3 layout, the converted tree equals JAX's leaf for
  leaf with dtypes and the source tree; ``params.msgpack``,
  ``project.yaml`` and ``classes.yaml`` are byte-identical (JAX's tree
  comes out of ``jax.tree_util.tree_map`` with sorted keys, which the port
  reproduces); both packages load the bundle and their forwards agree to
  1e-5; a module with no group raises JAX's ``KeyError``;
* ``convert-graph --mode xla``: the ``torch.export`` program, run in a
  fresh process that cannot import ``jaeger_tpu_torch``, ``jaeger_tpu``
  or JAX, reproduces the port's outputs to 1e-6 of their scale in f32
  and JAX's to 1e-5, on windows with N runs and short lengths (the masked
  program); in bf16 it reproduces the port's bf16 forward to 1e-6 and
  JAX's bf16 forward within the whole-model bf16 tolerance of
  ``tests/test_torch_model.py`` (5e-2 of the scale); ``--int8`` exports a
  ``full_int8`` bundle's int8 program, which reproduces the port's int8
  forward;
* the refused modes, a missing int8 bundle and a missing config exit 2
  with JAX's messages.
"""

import copy
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from jaeger_tpu import cli as jcli
from jaeger_tpu.models import artifacts as jart
from jaeger_tpu.models import modern_convert as jmc
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.utils.config import load_model_config as jax_load_config
from jaeger_tpu_torch import cli
from jaeger_tpu_torch.commands.predict_legacy import load_legacy_model
from jaeger_tpu_torch.models import modern_convert as tmc
from jaeger_tpu_torch.models.artifacts import (init_params, load_model,
                                               read_flax_msgpack, save_model)
from jaeger_tpu_torch.models.conversion import quantize_bundle
from jaeger_tpu_torch.models.legacy_convert import convert_wres_h5
from tests.test_modern_convert import CONFIG as MODERN_TINY
from tests.test_modern_convert import _write_keras3_fixture
from tests.test_torch_train import _narrow_flagship

ROOT = Path(__file__).resolve().parents[1]
WRES_H5 = ROOT / "jaeger_tpu" / "data" / "models" / "default" / "WRes_1024.h5"
TOL = 1e-5


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _assert_trees_equal(got, want, ordered=True):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert (list(g) == list(w)) if ordered else (sorted(g) == sorted(w))
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _jax_cli(argv):
    r = CliRunner().invoke(jcli.main, argv, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def _windows(crop_nt: int, n: int, seed: int = 0):
    """Windows with N runs, soft-masked bases and short lengths."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(n, crop_nt)).astype(np.uint8)
    bases[1, 10:40] = 4
    bases[2, 5:15] += 5
    lengths = np.full(n, crop_nt, np.int32)
    lengths[3] = crop_nt // 2
    lengths[4] = 7
    return bases, lengths


# --- convert-weights --family wres -------------------------------------------

def test_convert_weights_wres_h5_bytes_equal_jax(tmp_path):
    cli.main(["utils", "convert-weights", "-i", str(WRES_H5), "-o",
              str(tmp_path / "torch")])
    out = _jax_cli(["utils", "convert-weights", "-i", str(WRES_H5), "-o",
                    str(tmp_path / "jax")])
    assert "converted weights written to" in out
    for name in ("params.msgpack", "legacy.yaml"):
        assert (tmp_path / "torch" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "torch" / "legacy.yaml").read_text() == (
        f"family: wres\nnum_res_blocks: 5\nsource: {WRES_H5}\n")
    # the weights load in both packages: the port's legacy loader runs
    # the bundle, flax restores the same leaves
    from flax import serialization

    raw = (tmp_path / "torch" / "params.msgpack").read_bytes()
    _assert_trees_equal(read_flax_msgpack(tmp_path / "torch" /
                                          "params.msgpack"),
                        convert_wres_h5(WRES_H5))
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, serialization.msgpack_restore(raw)),
        convert_wres_h5(WRES_H5), ordered=False)
    model, _ = load_legacy_model(tmp_path / "torch", device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


def test_convert_weights_wres_refuses_other_files(tmp_path, capsys):
    src = tmp_path / "weights.bin"
    src.write_bytes(b"\0")
    with pytest.raises(SystemExit) as e:
        cli.main(["utils", "convert-weights", "-i", str(src), "-o",
                  str(tmp_path / "out")])
    assert e.value.code == 2
    msg = f"{src}: expected a SavedModel directory or a .h5 weights file"
    assert msg in capsys.readouterr().err
    r = CliRunner().invoke(jcli.main, ["utils", "convert-weights", "-i",
                                       str(src), "-o", str(tmp_path / "j")])
    assert r.exit_code == 2 and msg in r.output


def test_convert_weights_wres_names_a_missing_input(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["utils", "convert-weights", "-i", str(tmp_path / "none"),
                  "-o", str(tmp_path / "out")])
    assert e.value.code == 2
    assert "does not exist" in capsys.readouterr().err


# --- convert-weights --family modern -----------------------------------------

def _filled(config, seed):
    """JAX's init tree of ``config``, every leaf distinctive (positive, so
    moving variances stay valid)."""
    _, src = ModelBuilder(copy.deepcopy(config)).init(
        rng=jax.random.PRNGKey(123))
    rng = np.random.default_rng(seed)

    def fill(d):
        return {k: fill(v) if hasattr(v, "items") else
                rng.uniform(0.1, 1.0, size=np.shape(v)).astype(np.float32)
                for k, v in d.items()}

    return fill(src)


def _keras_class(leaves, shapes) -> str:
    """The snake-case Keras class a module's variables belong to."""
    keys = [k for _, k in leaves]
    if "kernel" in keys:
        return "masked_conv1d" if len(shapes[0]) == 3 else "dense"
    if "alpha" in keys:
        return "masked_dyt"
    if "gamma" in keys:
        return "masked_batch_normalization"
    if "embedding" in keys:
        return "embedding"
    return "nmd_layer"


def _write_keras3_in_creation_order(h5_path, variables):
    """Every module of ``variables`` as a Keras-3 group in creation order:
    ``layers/<class>[_<n>]/vars/<i>``, ``n`` Keras's per-class dedup
    counter, the variables in Keras order."""
    import h5py

    counts: dict = {}
    with h5py.File(h5_path, "w") as f:
        for path, leaves, shapes in jmc._tree_slots(variables):
            cls = _keras_class(leaves, shapes)
            n = counts.get(cls, 0)
            counts[cls] = n + 1
            g = f.create_group(f"layers/{cls}{f'_{n}' if n else ''}/vars")
            for i, (coll, key) in enumerate(leaves):
                node = variables[coll]
                for p in path:
                    node = node[p]
                for p in (key if isinstance(key, tuple) else (key,)):
                    node = node[p]
                g.create_dataset(str(i), data=np.asarray(node))
        f.create_group("optimizer/vars").create_dataset(
            "0", data=np.zeros((4,), np.float32))


@pytest.fixture(params=["tiny", "narrow_flagship"])
def modern_case(request, tmp_path):
    """(config, config file, h5, the source tree)."""
    if request.param == "tiny":
        config = copy.deepcopy(MODERN_TINY)
        src = _filled(config, 0)
        h5 = tmp_path / "modern_tiny.weights.h5"
        _write_keras3_fixture(h5, src)
    else:
        config = _narrow_flagship()
        src = _filled(config, 1)
        h5 = tmp_path / "narrow.weights.h5"
        _write_keras3_in_creation_order(h5, src)
    cfg_file = tmp_path / "project.yaml"
    cfg_file.write_text(yaml.safe_dump(config, sort_keys=False))
    return config, cfg_file, h5, src


def test_convert_modern_weights_equals_jax(modern_case):
    config, _, h5, src = modern_case
    got = tmc.convert_modern_weights(copy.deepcopy(config), h5)
    want = jmc.convert_modern_weights(copy.deepcopy(config), h5)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
    # every leaf came from the file, on the module it was written for
    g, s = dict(_leaves(got)), dict(_leaves(src))
    assert sorted(g) == sorted(s)
    for k in s:
        np.testing.assert_array_equal(g[k], s[k], err_msg=str(k))


def test_convert_weights_modern_bundle_equals_jax(modern_case, tmp_path):
    config, cfg_file, h5, _ = modern_case
    cli.main(["utils", "convert-weights", "--family", "modern", "-i",
              str(h5), "-c", str(cfg_file), "-o", str(tmp_path / "torch")])
    out = _jax_cli(["utils", "convert-weights", "--family", "modern", "-i",
                    str(h5), "-c", str(cfg_file), "-o",
                    str(tmp_path / "jax")])
    assert "converted modern bundle written to" in out
    for name in ("params.msgpack", "project.yaml", "classes.yaml"):
        assert (tmp_path / "torch" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name
    # both packages load the port's bundle; their forwards agree
    tmodel, tcfg, classes = load_model(tmp_path / "torch", device="cpu")
    jmodel, jvars, _, jclasses = jart.load_model(tmp_path / "torch")
    assert classes == jclasses
    bases, lengths = _windows(tmodel.crop_nt, 5)
    want = jmodel.apply(jvars, {"bases": jnp.asarray(bases),
                                "lengths": jnp.asarray(lengths)}, train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(bases), torch.from_numpy(lengths))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def test_convert_modern_weights_names_a_missing_module(tmp_path):
    config = copy.deepcopy(MODERN_TINY)
    src = _filled(config, 0)
    h5 = tmp_path / "short.weights.h5"
    _write_keras3_fixture(h5, src)
    import h5py

    with h5py.File(h5, "a") as f:
        del f["layers/dense_2"]     # the reliability head's dense
    with pytest.raises(KeyError, match="reliability/dense_0") as got:
        tmc.convert_modern_weights(copy.deepcopy(config), h5)
    with pytest.raises(KeyError) as want:
        jmc.convert_modern_weights(copy.deepcopy(config), h5)
    assert str(got.value) == str(want.value)


def test_convert_weights_modern_needs_a_config(tmp_path, capsys):
    h5 = tmp_path / "w.weights.h5"
    h5.write_bytes(b"\0")
    with pytest.raises(SystemExit) as e:
        cli.main(["utils", "convert-weights", "--family", "modern", "-i",
                  str(h5), "-o", str(tmp_path / "out")])
    assert e.value.code == 2
    msg = ("--family modern needs -c/--config (the project.yaml saved next "
           "to the weights)")
    assert msg in capsys.readouterr().err
    r = CliRunner().invoke(jcli.main, ["utils", "convert-weights",
                                       "--family", "modern", "-i", str(h5),
                                       "-o", str(tmp_path / "j")])
    assert r.exit_code == 2 and msg in r.output


# --- convert-graph -----------------------------------------------------------

#: runs every program of a spec in a process that cannot import the port,
#: the JAX package or JAX, on one CPU thread
RUNNER = textwrap.dedent("""
    import json, sys
    for m in ("jaeger_tpu_torch", "jaeger_tpu", "jax", "jaxlib", "flax"):
        sys.modules[m] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    spec = json.load(open(sys.argv[1]))
    for program, inputs, out in spec:
        ep = torch.export.load(program)
        z = np.load(inputs)
        got = ep.module()(torch.from_numpy(z["bases"]),
                          torch.from_numpy(z["lengths"]))
        assert all(v.dtype == torch.float32 for v in got.values())
        np.savez(out, **{k: v.numpy() for k, v in got.items()})
    print("ran", len(spec))
""")


def _run_programs(tmp_path, programs, bases, lengths) -> list[dict]:
    np.savez(tmp_path / "inputs.npz", bases=bases, lengths=lengths)
    spec = [(str(p), str(tmp_path / "inputs.npz"),
             str(tmp_path / f"out_{i}.npz")) for i, p in enumerate(programs)]
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(tmp_path / "spec.json")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [dict(np.load(out)) for _, _, out in spec]


@pytest.fixture(scope="module")
def graph_bundle(tmp_path_factory):
    """A narrow flagship bundle (masked batch norms, NMD taps) with seeded
    weights, and its full_int8 sibling ``<bundle>_int8``."""
    root = tmp_path_factory.mktemp("graph")
    config = _narrow_flagship()
    path = save_model(init_params(copy.deepcopy(config),
                                  torch.Generator().manual_seed(4)),
                      config, root / "model")
    quantize_bundle(path, root / "model_int8", mode="full_int8",
                    device="cpu")
    return path


def _port_forward(bundle, dtype, bases, lengths):
    model, _, _ = load_model(bundle, dtype=dtype, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(bases), torch.from_numpy(lengths))
    return {k: v.float().numpy() for k, v in out.items()}


def _jax_forward(bundle, dtype, bases, lengths):
    """JAX's ``model.apply(..., train=False)`` on the bundle's weights (read
    as numpy: ``jart.load_model`` would run ``init`` only for a template)."""
    model = ModelBuilder(jax_load_config(bundle / "project.yaml"),
                         dtype=dtype).build()
    variables = read_flax_msgpack(bundle / "params.msgpack")
    out = model.apply(variables, {"bases": jnp.asarray(bases),
                                  "lengths": jnp.asarray(lengths)},
                      train=False)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def test_convert_graph_programs_run_without_the_port(graph_bundle, tmp_path,
                                                     capsys):
    batch = 6
    programs = []
    for precision in ("float32", "bfloat16"):
        out = tmp_path / f"model_{precision}.pt2"
        cli.main(["utils", "convert-graph", "-m", str(graph_bundle), "-o",
                  str(out), "--precision", precision, "--batch",
                  str(batch)])
        assert f"torch.export program written to {out}" in (
            capsys.readouterr().out)
        programs.append(out)
    out = tmp_path / "model_int8.pt2"
    cli.main(["utils", "convert-graph", "-m", str(graph_bundle), "-o",
              str(out), "--precision", "float32", "--batch", str(batch),
              "--int8"])
    programs.append(out)
    crop_nt = load_model(graph_bundle, device="cpu")[0].crop_nt
    bases, lengths = _windows(crop_nt, batch, seed=5)
    f32, bf16, int8 = _run_programs(tmp_path, programs, bases, lengths)

    port32 = _port_forward(graph_bundle, torch.float32, bases, lengths)
    jax32 = _jax_forward(graph_bundle, jnp.float32, bases, lengths)
    assert set(f32) == set(port32) == set(jax32)
    for k in port32:
        _close(f32[k], port32[k], f"f32 {k} against the port", tol=1e-6)
        _close(f32[k], jax32[k], f"f32 {k} against JAX")

    port16 = _port_forward(graph_bundle, torch.bfloat16, bases, lengths)
    jax16 = _jax_forward(graph_bundle, jnp.bfloat16, bases, lengths)
    for k in port16:
        _close(bf16[k], port16[k], f"bf16 {k} against the port", tol=1e-6)
        # the whole-model bf16 tolerance of tests/test_torch_model.py
        _close(bf16[k], jax16[k], f"bf16 {k} against JAX", tol=5e-2)

    int8_bundle = graph_bundle.parent / "model_int8"
    port8 = _port_forward(int8_bundle, torch.float32, bases, lengths)
    for k in port8:
        _close(int8[k], port8[k], f"int8 {k} against the port", tol=1e-6)
    # the int8 program differs from the float one
    assert not np.array_equal(int8["prediction"], f32["prediction"])


@pytest.mark.parametrize("mode", ["tflite", "onnx", "tensorrt"])
def test_convert_graph_refuses_other_modes(graph_bundle, tmp_path, capsys,
                                           mode):
    argv = ["utils", "convert-graph", "-m", str(graph_bundle), "-o",
            str(tmp_path / "g.pt2"), "--mode", mode]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    msg = (f"--mode {mode}: the TFLite/ONNX/TensorRT engine zoo is replaced "
           "by the single XLA path (see docs/optimizations.md); use --mode "
           "xla.")
    assert msg in capsys.readouterr().err
    r = CliRunner().invoke(jcli.main, argv)
    assert r.exit_code == 2 and msg in " ".join(r.output.split())
    assert not (tmp_path / "g.pt2").exists()


def test_convert_graph_int8_needs_an_int8_bundle(tmp_path, capsys):
    config = copy.deepcopy(MODERN_TINY)
    bundle = save_model(init_params(config, torch.Generator().manual_seed(0)),
                        config, tmp_path / "float_only")
    with pytest.raises(SystemExit) as e:
        cli.main(["utils", "convert-graph", "-m", str(bundle), "-o",
                  str(tmp_path / "g.pt2"), "--int8"])
    assert e.value.code == 2
    assert f"no int8 bundle found for '{bundle}'" in capsys.readouterr().err
