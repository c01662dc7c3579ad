"""The benchmark's CPU tests: ``python -m pytest benchmark/tests``.

Tests marked ``card`` need a CUDA card; each decides inside the test
whether one is present and skips here with a reason. ``tiny_cell`` gives
a cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
model at 16 channels, 20 codons, batch 32, a few dozen contigs or a few
hundred rows, float32 unless asked otherwise.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


#: a cross-frame attention model (``train_config/fragment_3class_500bp_
#: crossframe.yaml`` as run), for the reference's attention and batch norm
CROSSFRAME = ROOT / "benchmark" / "tests" / "data" / "crossframe.json"


def shrink_model(m: dict) -> dict:
    m["embedding"]["embedding_size"] = 8
    m["string_processor"]["crop_size"] = 20
    for layer in m["representation_learner"]["hidden_layers"]:
        c = layer.get("config") or {}
        if "filters" in c:
            c["filters"] = 16
        if "embed_dim" in c:
            c.update(embed_dim=16, num_heads=2, feed_forward_dim=32)
    return m


def shrink(cell, precision: str = "float32"):
    shrink_model(cell.config["model"])
    for flow in ("predict", "train"):
        cell.config[flow].update(precision=precision, batch=32, fsize=65, stride=60,
                                 check_windows=320, trace_batches=[2, 3],
                                 trace_steps=[2, 3])
    params = cell.traffic["params"]
    if cell.traffic["driver"] == "predict":
        params.update(contigs=40, min_len=300, max_len=3000)
    else:
        params.update(rows=512)
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark.harness.cell import load_cell

    def make(workload: str, precision: str = "float32"):
        return shrink(load_cell(workload), precision)
    return make


@pytest.fixture
def tiny_model():
    """A cell's model, or ``"crossframe"``, cut as ``tiny_cell`` cuts it."""
    from benchmark.harness.cell import load_cell

    def make(name: str) -> dict:
        if name == "crossframe":
            return shrink_model(json.loads(CROSSFRAME.read_text())["model"])
        return shrink_model(load_cell(name).config["model"])
    return make
