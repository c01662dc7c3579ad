"""The port's data-parallel inference and training against `jaeger_tpu`.

Covered, on the CPU:

* the engine on ``DeviceMesh(("cpu",) * 2)`` and ``* 3`` (a width that
  pads the batch and the split bucket), dense and split programs, full
  and reduced outputs, against JAX's engine on ``meshlib.data_mesh(2)``
  of the test's eight virtual CPU devices: outputs within 1e-5;
* one step of the flagship template cut narrow (C = 16, a 40-codon crop)
  with masked batch norms and NMD taps, on a batch with N runs (the masked
  program), in two gloo processes (each its half of the rows) against
  JAX's ``shard_train_step`` on a two-device mesh: the loss within 1e-5
  relative, the moving statistics within 1e-5 of their scale, every
  gradient within 5e-5 of its leaf's scale (this needs the differentiable
  all-reduce of the batch statistics: without its backward the gradients
  through the statistics are missing), the parameters as
  ``tests/test_torch_train.py`` holds them after Adam's sign-like first
  step; both processes end with equal parameters; a one-process gloo
  group gives the same step as no group;
* ``train --coordinator 127.0.0.1:<port> --num-processes 2 --process-id
  K`` in two processes against one process on the same global stream:
  the final parameters within 1e-5 of their scale, the same files, and
  process 1 (given a directory of its own) writes nothing.

Every process a test starts runs under ``subprocess`` with a timeout, and
every process group has one, so a collective that one process skips
fails the test instead of hanging the run. The processes run with one
CPU thread each.
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

from jaeger_tpu.infer.engine import InferenceEngine as JaxEngine
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.parallel import mesh as jmesh
from jaeger_tpu.train import loop as jloop
from jaeger_tpu.train import optimizers as jopt
from jaeger_tpu_torch.infer.engine import InferenceEngine
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.parallel.mesh import DeviceMesh
from tests.test_dense_path import CONFIG
from tests.test_engine_split import _mixed_windows, _window_batch
from tests.test_torch_train import (_batch, _capture, _check_params, _close,
                                    _flat, _init_variables, _narrow_flagship,
                                    _randomize)

ROOT = Path(__file__).resolve().parent.parent
#: seconds a process of these tests may take before it counts as hung
PROC_TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}


def _run_all(argvs: list, cwd=ROOT) -> list[str]:
    """Start every command at once, wait for all with a timeout each;
    the outputs, or a failure with them."""
    procs = [subprocess.Popen(a, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


# --- the engine on a data mesh -----------------------------------------------

@pytest.fixture(scope="module")
def engine_model():
    b = ModelBuilder(CONFIG)
    model, variables = b.init()
    tmodel = build_model(CONFIG)
    load_state(tmodel, params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return b.crop[1], model, variables, tmodel


@pytest.fixture
def one_cpu_thread():
    """Torch's CPU kernels on one thread for the test. The first
    multi-threaded ``torch.tanh`` of a process sometimes computes one
    OpenMP thread's share of the tensor with another approximation (up
    to about 1,500 ulps), which moved the engine's first forward by up to
    3.5e-5 of the embedding's scale; on one thread the first call agrees
    with the later ones (ROADMAP.md queue 3, "About the reference")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("width", [2, 3])
@pytest.mark.parametrize("case", ["dense", "split"])
def test_engine_on_a_mesh_matches_jax(engine_model, one_cpu_thread, width,
                                      case):
    crop_nt, model, variables, tmodel = engine_model
    rng = np.random.default_rng(width)
    if case == "split":
        bases, lengths = _mixed_windows(rng, crop_nt, n=45,
                                        masked_positions=(3, 20, 40))
    else:
        bases = rng.integers(0, 4, size=(45, crop_nt)).astype(np.uint8)
        lengths = np.full(45, crop_nt, np.int32)
    jeng = JaxEngine(model, variables, batch_size=32,
                     mesh=jmesh.data_mesh(2))
    teng = InferenceEngine(tmodel, batch_size=32, device="cpu",
                           mesh=DeviceMesh(("cpu",) * width))
    assert teng.batch_size == jmesh.pad_to_multiple(32, width)
    want = jeng.predict_windows(bases, lengths)
    got = teng.predict_windows(bases, lengths)
    programs = {p for _, p in teng.program_counts}
    assert programs == ({"dense", "masked"} if case == "split"
                        else {"dense"})
    if case == "split":
        # the bucket is a multiple of the mesh width
        bucket = min(r for r, _ in teng.program_counts)
        assert bucket % width == 0 and bucket < teng.batch_size
    assert set(got) == set(want)
    for key in want:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=key)
    # the reduced path, with contigs spanning the batches
    batch = _window_batch(bases, lengths, np.repeat(np.arange(9), 5))
    want_r, _ = jeng.predict_batches_reduced([batch], num_classes=3)
    got_r, _ = teng.predict_batches_reduced([batch], num_classes=3)
    assert got_r.keys() == want_r.keys()
    for g in want_r:
        np.testing.assert_array_equal(got_r[g]["frag_pred"],
                                      want_r[g]["frag_pred"])
        for key in ("pred_sum", "reliability"):
            a = np.asarray(got_r[g][key], np.float64)
            r = np.asarray(want_r[g][key], np.float64)
            step = np.spacing(np.abs(r).astype(np.float16)).astype(
                np.float64)
            assert np.all(np.abs(a - r) <= step + 1e-12), (g, key)


def test_engine_mesh_refuses_a_seq_mesh_beside_it(engine_model):
    tmodel = engine_model[3]
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferenceEngine(tmodel, device="cpu", mesh=DeviceMesh(("cpu",) * 2),
                        seq_mesh=DeviceMesh(("cpu",) * 2, "seq"))


# --- one train step in two processes -----------------------------------------

STEP_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, work, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
from jaeger_tpu_torch.parallel import multihost as mh
if world:
    mh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                              backend="gloo", device="cpu", timeout_s=120)
from jaeger_tpu_torch.models.artifacts import load_state
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.train import loop, optimizers
spec = json.load(open(f"{work}/spec.json"))
model = build_model(spec["config"])
load_state(model, torch.load(f"{work}/state.pt"))
tx = optimizers.make_optimizer(spec["optimizer"], spec["optimizer_params"])
step = loop.make_dispatching_train_step(
    model, loop.StepConfig(loss_name=spec["loss"],
                           loss_params=spec["loss_params"],
                           reg_specs=tuple(tuple(r) for r in spec["reg"])),
    "cpu", global_batcher=mh.GlobalBatcher() if world else None)
state = loop.TrainState.create(model, tx)
batch = dict(np.load(f"{work}/batch.npz"))
state, metrics = step(state, batch, torch.Generator().manual_seed(0))
torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
            "programs": dict(step.program_counts), "grads": state.grads,
            "state": model.state_dict()}, f"{out}/out{rank}.pt")
mh.shutdown_distributed()
"""


def _bn_flagship() -> dict:
    """The narrow flagship with masked batch norms in place of its DYT
    norms (the template's own alternative), NMD taps kept."""
    cfg = _narrow_flagship()
    for layer in cfg["model"]["representation_learner"]["hidden_layers"]:
        if layer["name"] == "masked_dyt":
            layer["name"] = "masked_batchnorm"
            layer["config"] = {}
        elif layer["name"] == "residual_block":
            layer["config"]["norm_type"] = "masked_batchnorm"
    return cfg


@pytest.fixture(scope="module")
def two_process_step(tmp_path_factory):
    """The step in two gloo processes, in one, and with no group; and
    JAX's ``shard_train_step`` on a two-device mesh."""
    work = tmp_path_factory.mktemp("step")
    cfg = _bn_flagship()
    train_cfg = cfg["training"]
    variables = _randomize(_init_variables(cfg, 4), seed=4)
    torch.save(params_from_jax(variables), work / "state.pt")
    crop = build_model(copy.deepcopy(cfg)).crop_nt
    batch = _batch(np.random.default_rng(8), crop, "masked", 6, n=8)
    batch["bases"][5, 30:90] = 4                 # an N run in rank 1's rows
    np.savez(work / "batch.npz", **batch)
    reg = [list(r) for r in ModelBuilder(copy.deepcopy(cfg))
           .regularizer_specs()]
    spec = dict(config=cfg, optimizer=train_cfg["optimizer"],
                optimizer_params=train_cfg["optimizer_params"],
                loss=train_cfg["loss_classifier"],
                loss_params=train_cfg["loss_params_classifier"], reg=reg)
    (work / "spec.json").write_text(json.dumps(spec))
    script = work / "step_worker.py"
    script.write_text(STEP_WORKER)
    runs = {}
    for name, world in (("two", 2), ("one", 1), ("none", 0)):
        port = str(_free_port())
        (work / name).mkdir()
        _run_all([[sys.executable, str(script), str(r), str(world), port,
                   str(work), str(work / name)]
                  for r in range(max(world, 1))])
        runs[name] = [torch.load(work / name / f"out{r}.pt")
                      for r in range(max(world, 1))]
    # JAX: the same step, the batch sharded over two of its CPU devices
    model = ModelBuilder(copy.deepcopy(cfg)).build()
    tx = jopt.make_optimizer(train_cfg["optimizer"],
                             train_cfg["optimizer_params"])
    jcfg = jloop.StepConfig(loss_name=spec["loss"],
                            loss_params=spec["loss_params"],
                            reg_specs=tuple(tuple(r) for r in reg))
    mesh = jmesh.data_mesh(2)
    state = jax.device_put(
        jloop.TrainState.create(variables, optax.chain(_capture(), tx)),
        jmesh.replicate(mesh))
    step = jloop.shard_train_step(jloop.make_train_step(model, jcfg), mesh)
    dev = jax.device_put(batch, jmesh.shard_along(mesh))
    new_state, metrics = step(state, dev, jax.random.PRNGKey(0))
    return runs, variables, new_state, metrics, train_cfg


def test_two_process_step_matches_jax_shard_train_step(two_process_step):
    runs, variables, new_state, jm, train_cfg = two_process_step
    got = runs["two"][0]
    assert got["programs"] == {"masked": 1}
    for m in ("loss", "total_loss", "grad_norm", "accuracy"):
        _close(got["metrics"][m], float(jm[m]), m)
    jg = _flat(new_state.opt_state[0])
    assert set(got["grads"]) == set(jg)
    overall = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        _close(got["grads"][k].numpy(), jg[k], f"grad {k}", 5e-5, overall)
    want_stats = _flat(new_state.batch_stats)
    got_stats = {k.replace(".", "/"): v.numpy()
                 for k, v in got["state"].items()
                 if k.endswith(("moving_mean", "moving_variance"))}
    assert set(got_stats) == set(want_stats)
    assert any("nmd" in k for k in got_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], f"batch_stats {k}")
    tm = build_model(_bn_flagship())
    load_state(tm, got["state"])
    lr = float(train_cfg["optimizer_params"]["learning_rate"])
    _check_params(tm, variables["params"], new_state.params, jg, lr)


def test_two_processes_agree_and_one_rank_group_is_no_group(
        two_process_step):
    runs = two_process_step[0]
    r0, r1 = runs["two"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert r0["metrics"] == r1["metrics"]
    one, none = runs["one"][0], runs["none"][0]
    assert one["metrics"] == none["metrics"]
    for k, v in none["state"].items():
        assert torch.equal(one["state"][k], v), k


# --- train through the CLI in two processes ----------------------------------

def test_cli_train_two_processes_equals_one(tmp_path):
    """The tiny config with a DYT norm in place of its batch norm: a conv
    bias before a batch norm has a gradient of exactly zero, so its
    rounding noise, which differs with the reduction order, drives Adam's
    sign-like steps apart; here every gradient is a real one."""
    import yaml

    cfg = yaml.safe_load((ROOT / "tests" / "data" / "tiny_config.yaml")
                         .read_text())
    for layer in cfg["model"]["representation_learner"]["hidden_layers"]:
        if layer["name"] == "masked_batchnorm":
            layer["name"] = "masked_dyt"
    cfg_path = tmp_path / "tiny_dyt.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    port = _free_port()
    cli = [sys.executable, "-m", "jaeger_tpu_torch.cli", "train", "-c",
           str(cfg_path), "--device", "cpu", "--steps-per-epoch", "3"]
    # process 1 is given a directory of its own, to show it writes none
    logs = _run_all(
        [cli + ["-o", str(tmp_path / ("dp" if k == 0 else "dp_rank1")),
                "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "2", "--process-id", str(k)] for k in range(2)]
        + [cli + ["-o", str(tmp_path / "single")]])
    assert "process 1/2 on cpu" in "".join(logs)
    assert not (tmp_path / "dp_rank1").exists()
    from jaeger_tpu_torch.models.artifacts import read_flax_msgpack

    got = _flat(read_flax_msgpack(tmp_path / "dp" / "params.msgpack"))
    want = _flat(read_flax_msgpack(tmp_path / "single" / "params.msgpack"))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    assert (sorted(p.name for p in (tmp_path / "dp").iterdir())
            == sorted(p.name for p in (tmp_path / "single").iterdir()))
