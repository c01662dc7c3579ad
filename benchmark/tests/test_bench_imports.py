"""What the benchmark loads: nothing of JAX or the JAX package, compared
by whole top-level name; and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.cell import ROOT
from benchmark.harness.main import FORBIDDEN

BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not _top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "jaeger_tpu_torch" not in _top_imports(path)


def test_the_forbidden_names_are_whole():
    assert "jaeger_tpu" in FORBIDDEN and "jaeger_tpu_torch" not in FORBIDDEN


def test_every_module_a_run_loads_is_clean():
    """A fresh process loads what ``benchmark/run.py`` loads for every cell
    (the harness, the drivers, generators and metric readers, and the port
    modules the drivers call) and lists the top-level names."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness.cell import load_cell
from benchmark.harness import main
spec = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for w in spec["workloads"]:
    cell = load_cell(w["name"])
    cell.driver(); cell.generator()
    for m in cell.per_layer:
        cell.metric_reader(m["name"])
import benchmark.controls
import jaeger_tpu_torch.infer.engine, jaeger_tpu_torch.seqops.windows
import jaeger_tpu_torch.train.loop, jaeger_tpu_torch.train.data
import jaeger_tpu_torch.commands.train, jaeger_tpu_torch.models.conversion
import jaeger_tpu_torch.ops.cuda_build, jaeger_tpu_torch.ops.fused_conv_grad
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "jaeger_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
