"""The port's ``predict`` end to end, its device default and its imports.

* With the bundled demo model at float32 on the CPU, the port's CLI must
  write a ``_default_jaeger.tsv`` byte-identical to JAX ``run_core``'s on
  ``jaeger_tpu/data/test/test_contigs.fasta`` (the CLI's defaults on both
  sides: 2000 nt windows, stride 1500, batch 96, rc 0.1, pc 3.0), on the
  device-reduced path and on the full-logits path (CRF decoding and the
  window-score NPZ, whose per-window logits agree to 1e-5: f32 sums in
  another order).
* Entry points run on CUDA unless told otherwise: without a card they
  raise instead of falling back to the CPU.
* ``jaeger_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the
  JAX package: every module imports in a fresh interpreter where those
  imports are blocked.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
DEMO = ROOT / "jaeger_tpu" / "data" / "models" / "demo"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
           "jaeger_tpu", "triton", "h5py", "joblib", "sklearn")


def _port_modules() -> list[str]:
    pkg = ROOT / "jaeger_tpu_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))


@pytest.mark.parametrize("full_logits", [False, True])
def test_predict_tsv_byte_identical_to_jax(tmp_path, full_logits):
    """``full_logits``: CRF decoding and the window-score NPZ, which take
    the per-window logits path instead of the device-reduced one."""
    import numpy as np

    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch import cli

    jax_table = jax_run_core(
        input_path=str(FASTA), output_dir=str(tmp_path / "jax"),
        model_path=str(DEMO), fsize=2000, stride=1500, batch=96,
        precision="float32", reliability_cutoff=0.1, phage_score=3.0,
        crf_switch_cost=2.0 if full_logits else None,
        save_window_scores=full_logits)
    extra = ["--crf", "--window-scores"] if full_logits else []
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp_path / "torch"),
              "--precision", "float32", "--device", "cpu", "--workers", "1",
              *extra])
    torch_table = tmp_path / "torch" / jax_table.name
    want = jax_table.read_bytes()
    assert want.count(b"\n") == 10                # header + 9 contigs
    assert torch_table.read_bytes() == want
    if full_logits:
        name = "test_contigs_window_scores.npz"
        with np.load(tmp_path / "jax" / name, allow_pickle=True) as a, \
                np.load(tmp_path / "torch" / name, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in ("headers", "lengths"):
                np.testing.assert_array_equal(a[key], b[key])
            for wa, wb in zip(a["predictions"], b["predictions"]):
                np.testing.assert_allclose(wb, wa, rtol=1e-5, atol=1e-5)


def test_predict_seq_shard_without_hyena_and_an_ensemble(tmp_path):
    """``seq_shard`` on a model without Hyena blocks (the demo) rebuilds it
    with the seq axis and predicts the demo's own TSV (the sharded Hyena
    stack is tests/test_torch_hyena_sp.py's, multi-host runs
    tests/test_torch_multihost.py's); a one-member ensemble of the demo
    predicts the demo's own TSV too (tests/test_torch_ensemble.py holds
    ensembles against JAX)."""
    import yaml

    from jaeger_tpu_torch.commands.predict import run_core

    ensemble = tmp_path / "ensemble"
    ensemble.mkdir()
    (ensemble / "ensemble.yaml").write_text(yaml.safe_dump(
        {"method": "mean", "members": [str(DEMO.resolve())]}))
    common = dict(fsize=2000, stride=1500, precision="float32",
                  device="cpu", workers=1)
    got = run_core(str(FASTA), str(tmp_path / "ens"), str(ensemble),
                   **common)
    want = run_core(str(FASTA), str(tmp_path / "demo"), str(DEMO), **common)
    assert got.read_bytes() == want.read_bytes()
    sharded = run_core(str(FASTA), str(tmp_path / "seq"), str(DEMO),
                       seq_shard=2, **common)
    assert sharded.read_bytes() == want.read_bytes()


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.utils.devices import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(DEMO)
    model, _, _ = load_model(DEMO, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp_path)])
    assert not (tmp_path / "test_contigs_default_jaeger.tsv").exists()


def test_port_imports_without_jax():
    modules = _port_modules()
    for name in ("ops.fused_conv", "ops.int8_conv", "models.conversion",
                 "ops.fused_conv_grad", "train.loop", "train.optimizers",
                 "commands.train", "postprocess.threshold", "models.legacy",
                 "models.legacy_convert", "models.modern_convert",
                 "commands.predict_legacy", "postprocess.legacy_collect",
                 "commands.health", "commands.taxonomy", "commands.utils",
                 "utils.registry", "utils.stats", "utils.receptive_field",
                 "seqops.stats", "seqops.transform", "seqops.synthetic",
                 "dataops.split", "dataops.ood", "dataops.dedupe",
                 "dataops.convert", "parallel.mesh", "parallel.multihost",
                 "parallel.hyena_sp"):
        assert f"jaeger_tpu_torch.{name}" in modules
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import runpy\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='smoke')\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_no_jax_import_statements():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|jaeger_tpu)\b",
        re.MULTILINE)
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "jaeger_tpu_torch").rglob("*.py"))]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory: no repository around it
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
