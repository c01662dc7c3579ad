"""The port's sequence-sharded Hyena against `jaeger_tpu`'s, on the CPU.

JAX runs its ring under a jitted ``shard_map`` on the test's virtual CPU
mesh; the
port runs its ring on ``DeviceMesh(("cpu",) * width, "seq")``. Covered:

* ``ring_causal_conv`` and ``hyena_recurrence_sp`` at widths 2 and 4
  against JAX's on the same numpy inputs: f32 within 1e-5 of the scale
  (the FFT is pocketfft in JAX and PyTorch's own here), the bf16 Toeplitz
  route within bf16 rounding (2 ulps + 2^-8 of the scale, as
  ``tests/test_torch_hyena.py``); the ring against the gathered oracle and
  the unsharded convolution; its gradients (inputs and filters, through
  the ring's copies) within 1e-4 of the unsharded convolution's; the
  filter segments equal to JAX's;
* ``run_core --seq-shard 2`` and ``4`` on the seeded Hyena bundle of
  JAX's own ``--seq-shard`` test (a crop of 83 codons, so the length
  pads to the width): the TSV byte-identical to ``--seq-shard 1`` and to
  JAX's ``--seq-shard 2``, also from the CLI; on the narrow template the
  window scores within 1e-5 of the scale;
* ``train`` of a config with ``model.parallel.seq_axis`` and
  ``training.seq_shard: 2``: one step's gradients within 1e-4 of the
  unsharded step's, and the bundle, written without ``seq_axis``, loads in
  ``jaeger_tpu`` with the same outputs.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jaeger_tpu.parallel import hyena_sp as jsp
from jaeger_tpu_torch.models.layers import causal_fft_convolve
from jaeger_tpu_torch.parallel import hyena_sp as tsp
from jaeger_tpu_torch.parallel.mesh import DeviceMesh, use_mesh
from tests.test_torch_hyena import narrow
from tests.test_torch_layers_zoo import _check
from tests.test_torch_templates import FASTA, _close, _variables

WIDTHS = [2, 4]


def _jmesh(width):
    return Mesh(np.array(jax.devices()[:width]), ("seq",))


def _tmesh(width):
    return DeviceMesh(("cpu",) * width, "seq")


def _inputs(seed, b=2, d=8, length=64, order=2):
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(order + 1, b, d, length)).astype(np.float32)
    decay = np.exp(-np.arange(length) / 24.0)
    filt = (rng.normal(size=(order, d, length)) * decay).astype(np.float32)
    return proj, filt


def _jax_ring(z, h, width):
    from jax import shard_map

    spec = P(None, None, "seq")
    mesh = _jmesh(width)
    fn = jax.jit(shard_map(lambda a, b: jsp.ring_causal_conv(a, b, "seq"),
                           mesh=mesh, in_specs=(spec, P()), out_specs=spec))
    return np.asarray(fn(jax.device_put(jnp.asarray(z),
                                        NamedSharding(mesh, spec)),
                         jnp.asarray(h)).astype(jnp.float32))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_matches_jax(width, dtype):
    proj, filt = _inputs(width)
    z, h = proj[0], filt[0]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax_ring(jnp.asarray(z, jdt), h, width)
    mesh = _tmesh(width)
    chunks = mesh.shard_along(torch.from_numpy(z).to(tdt), dim=-1)
    got = mesh.gather(tsp.ring_causal_conv(chunks, torch.from_numpy(h),
                                           mesh), dim=-1)
    assert got.dtype == tdt
    _check(got, want, dtype, "ring")


@pytest.mark.parametrize("width", WIDTHS)
def test_recurrence_matches_jax_and_the_unsharded(width):
    proj, filt = _inputs(10 + width)
    want = np.asarray(jax.jit(jsp.make_sequence_sharded_hyena(
        _jmesh(width), "seq"))(jnp.asarray(np.swapaxes(proj, 2, 3)),
                               jnp.asarray(filt)))
    got = tsp.sequence_sharded_hyena_op(torch.from_numpy(proj),
                                        torch.from_numpy(filt),
                                        _tmesh(width))
    _check(got.transpose(1, 2), want, "f32", "recurrence")
    z = torch.from_numpy(proj[0])
    for i in range(filt.shape[0]):
        z = causal_fft_convolve(z, torch.from_numpy(filt[i])) * \
            torch.from_numpy(proj[i + 1])
    _check(got, z.numpy(), "f32", "unsharded")


def test_filter_segments_and_gathered_oracle_match():
    proj, filt = _inputs(3, length=48)
    h = filt[0]
    for width in WIDTHS:
        s = 48 // width
        np.testing.assert_array_equal(
            tsp._filter_segments(torch.from_numpy(h), width, s).numpy(),
            np.asarray(jsp._filter_segments(jnp.asarray(h), width, s)))
        mesh = _tmesh(width)
        chunks = mesh.shard_along(torch.from_numpy(proj[0]), dim=-1)
        ring = mesh.gather(tsp.ring_causal_conv(chunks, torch.from_numpy(h),
                                                mesh), dim=-1)
        oracle = mesh.gather(tsp.gathered_causal_conv(
            chunks, torch.from_numpy(h), mesh), dim=-1)
        _check(ring, oracle.numpy(), "f32", "oracle")


@pytest.mark.parametrize("width", WIDTHS)
def test_ring_gradients_match_the_unsharded(width):
    proj, filt = _inputs(20 + width, b=1, d=4, length=32)
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 4, 32)).astype(np.float32))

    def grads(fn):
        p = torch.from_numpy(proj).requires_grad_(True)
        f = torch.from_numpy(filt).requires_grad_(True)
        loss = torch.sum(fn(p, f) * w)
        return torch.autograd.grad(loss, (p, f))

    def unsharded(p, f):
        z = p[0]
        for i in range(f.shape[0]):
            z = causal_fft_convolve(z, f[i]) * p[i + 1]
        return z

    want = grads(unsharded)
    got = grads(lambda p, f: tsp.sequence_sharded_hyena_op(
        p, f, _tmesh(width)))
    for g, r, name in zip(got, want, ("projections", "filters")):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()),
                                   err_msg=name)


# --- the model: predict --seq-shard and train with parallel.seq_axis ---------

@pytest.fixture(scope="module")
def hyena_bundle(tmp_path_factory):
    from jaeger_tpu_torch.models.artifacts import params_from_jax, save_model

    cfg = narrow()
    bundle = tmp_path_factory.mktemp("hyena_sp") / "bundle"
    save_model(params_from_jax(_variables(cfg, 21)), cfg, bundle)
    return bundle


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    """The bundle and FASTA of JAX's own ``--seq-shard`` test
    (``tests/test_hyena_seq_cli.py``: its config, JAX's initialization,
    four random contigs from seed 11)."""
    from jaeger_tpu.models.artifacts import save_model as jax_save_model
    from jaeger_tpu.models.builder import ModelBuilder
    from tests.test_hyena_seq_cli import CFG

    tmp = tmp_path_factory.mktemp("hyseq")
    _, variables = ModelBuilder(CFG).init()
    jax_save_model(variables, CFG, tmp / "model")
    rng = np.random.default_rng(11)
    with (tmp / "contigs.fasta").open("w") as fh:
        for i, ln in enumerate([900, 720, 505, 300]):
            seq = "".join(rng.choice(list("ACGT"), size=ln))
            fh.write(f">hy_contig_{i}\n{seq}\n")
    return tmp / "model", tmp / "contigs.fasta"


def test_run_core_seq_shard_tsv_byte_identical(tmp_path, jax_fixture):
    """JAX's fixture at JAX's arguments: the port's TSV at widths 2 and 4
    byte-identical to width 1 and to JAX's at width 2; the CLI's
    ``--seq-shard 2`` writes the same."""
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.predict import run_core

    bundle, fasta = jax_fixture
    common = dict(input_path=str(fasta), model_path=str(bundle), fsize=300,
                  stride=300, min_len=300, batch=16, precision="float32",
                  scan_termini=False)
    one = run_core(output_dir=str(tmp_path / "w1"), device="cpu", workers=1,
                   **common).read_bytes()
    assert one.count(b"\n") == 5
    for width in (2, 4):
        got = run_core(output_dir=str(tmp_path / f"w{width}"), device="cpu",
                       workers=1, seq_shard=width, **common)
        assert got.read_bytes() == one, width
    want = jax_run_core(output_dir=str(tmp_path / "jax"), seq_shard=2,
                        **common).read_bytes()
    assert want == one
    cli.main(["predict", "-i", str(fasta), "-o", str(tmp_path / "cli"), "-m",
              str(bundle), "--fsize", "300", "--stride", "300", "--min-len",
              "300", "--seq-shard", "2", "--no-termini", "--precision",
              "float32", "--device", "cpu", "--workers", "1"])
    assert (tmp_path / "cli" / "contigs_default_jaeger.tsv"
            ).read_bytes() == one


def test_seq_shard_window_scores_on_the_template(tmp_path, hyena_bundle):
    """The narrow template (seed 21, windows of its 254-nt crop): the
    window scores at ``--seq-shard 2`` within 1e-5 of the scale of width
    1's and of JAX's at ``--seq-shard 2``. (Neither package's ring sums
    bit for bit as its unsharded FFT; on this bundle the port's TSV
    rounds one variance to the neighbouring float16 value, ROADMAP.md
    queue 3.)"""
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.models.artifacts import load_model

    crop = load_model(hyena_bundle, device="cpu")[0].crop_nt
    common = dict(input_path=str(FASTA), model_path=str(hyena_bundle),
                  fsize=crop, stride=crop, batch=512, precision="float32",
                  save_window_scores=True, scan_termini=False)
    name = "test_contigs_window_scores.npz"
    scores = {}
    for key, fn, kw in (("one", run_core, {"device": "cpu"}),
                        ("two", run_core, {"device": "cpu", "seq_shard": 2}),
                        ("jax", jax_run_core, {"seq_shard": 2})):
        fn(output_dir=str(tmp_path / key), **common, **kw)
        with np.load(tmp_path / key / name, allow_pickle=True) as z:
            scores[key] = np.concatenate(
                [np.asarray(p, np.float32) for p in z["predictions"]])
    scale = float(np.abs(scores["one"]).max())
    for ref in ("one", "jax"):
        np.testing.assert_allclose(scores["two"], scores[ref], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=ref)


def test_seq_sharded_model_forward_and_step(hyena_bundle):
    """The narrow template built with ``seq_axis`` under a width-2 mesh:
    its forward equals the unsharded model's, and so do one train step's
    gradients (within 1e-4 of each leaf's scale)."""
    from jaeger_tpu_torch.models.artifacts import load_model, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.train import loop as tloop
    from jaeger_tpu_torch.train import optimizers as topt
    from tests.test_torch_templates import _bases

    base, cfg, _ = load_model(hyena_bundle, device="cpu")
    scfg = copy.deepcopy(cfg)
    scfg["model"]["parallel"] = {"seq_axis": "seq"}
    sharded = build_model(scfg)
    load_state(sharded, base.state_dict())
    bases, lengths = _bases(np.random.default_rng(2), base.crop_nt,
                            "masked", 4)
    mesh = _tmesh(2)
    with pytest.raises(ValueError, match="not in the ambient mesh"):
        sharded(torch.from_numpy(bases), torch.from_numpy(lengths))
    with torch.inference_mode(), use_mesh(mesh):
        got = sharded(torch.from_numpy(bases), torch.from_numpy(lengths))
    with torch.inference_mode():
        want = base(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), k)
    labels = np.eye(int(cfg["model"]["classifier_out_dim"]),
                    dtype=np.float32)[[0, 1, 2, 0]]
    batch = {"bases": bases, "lengths": lengths, "labels": labels}
    out = []
    for model, seq_mesh in ((base, None), (sharded, mesh)):
        state = tloop.TrainState.create(model, topt.make_optimizer("adam",
                                                                  {}))
        step = tloop.make_dispatching_train_step(
            model, tloop.StepConfig(heads=("prediction",)), "cpu")
        with use_mesh(seq_mesh):
            state, metrics = step(state, batch, torch.Generator())
        out.append((float(metrics["loss"]), state.grads))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for k, g in out[0][1].items():
        scale = max(float(g.abs().max()), 1e-6)
        np.testing.assert_allclose(out[1][1][k].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_train_with_seq_axis_writes_a_bundle_without_it(tmp_path):
    import yaml

    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.models.artifacts import load_model
    from tests.test_torch_templates import _bases, _train_data

    cfg = narrow()
    cfg["model"]["parallel"] = {"seq_axis": "seq"}
    path = _train_data(tmp_path, "hyena", cfg)
    data = yaml.safe_load(path.read_text())
    data["training"]["seq_shard"] = 2
    data["training"]["classifier_train_steps"] = 2
    path.write_text(yaml.safe_dump(data, sort_keys=False))
    out = tmp_path / "run"
    r = train_fragment_core(str(path), str(out), device="cpu")
    assert r["history"]["classifier"]
    saved = yaml.safe_load((out / "project.yaml").read_text())
    assert "parallel" not in saved["model"]
    tm, _, _ = load_model(out, device="cpu")
    jm, jvars, _, _ = jax_load_model(out)
    bases, lengths = _bases(np.random.default_rng(4), tm.crop_nt, "dense", 3)
    want = jm.apply(jvars, {"bases": jnp.asarray(bases),
                            "lengths": jnp.asarray(lengths)})
    with torch.inference_mode():
        got = tm(torch.from_numpy(bases), torch.from_numpy(lengths))
    for k in want:
        _close(got[k].numpy(), want[k], k)
