"""The harness finds every part of a cell by name, and a later change adds
a configuration, a traffic mix, a driver and a per-layer metric as new
files and entries, with no existing file edited."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness.cell import ROOT, load_cell, load_module

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves(workload):
    cell = load_cell(workload)
    assert cell.config["name"] == cell.config_name
    assert callable(cell.driver().run)
    assert callable(cell.generator().make)
    assert set(cell.limits) in ({"windows", "reduce", "window_logit_ratio"},
                                {"grad_ratio", "change_median"})
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(cell.metric_reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_files_declare_what_the_spec_says(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    module = load_module(ROOT / "benchmark" / "metrics" / f"{metric}.py", "m")
    assert (module.LAYER, module.UNIT, module.MOVES) == (
        entry["layer"], entry["unit"], entry["moves"])


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_source(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "flagship.json").read_text())
    cfg["name"] = "flagship_b96"
    cfg["replay"] = {"batch": 96}
    (bench / "configs" / "flagship_b96.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "gapped.json").write_text(json.dumps(
        {"driver": "replay", "generator": "gapped", "params": {"gap_every": 5000}}))
    (bench / "generators" / "gapped.py").write_text(
        "def make(params, seed, workdir):\n    return {'gap_every': params['gap_every']}\n")
    (bench / "drivers" / "replay.py").write_text(
        "def run(cell, seed, seconds, trace, device, workdir, t_start):\n"
        "    return {'batch': cell.settings['batch']}\n")
    (bench / "metrics" / "gap_share.predict.py").write_text(
        "LAYER = 'engine'\nUNIT = '%'\nMOVES = 'predict_windows_per_s'\n"
        "def read(ctx):\n    return ctx.get('gap_share')\n")
    (bench / "limits" / "flagship_b96.gapped.json").write_text(json.dumps({"windows": 0}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "flagship_b96", "source": "x",
                            "file": "benchmark/configs/flagship_b96.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "flagship_b96.gapped", "config": "flagship_b96",
                              "traffic": "gapped", "chips": 1, "why": "x"})
    spec["end_to_end"][1]["workloads"].append("flagship_b96.gapped")
    spec["per_layer"].append({"name": "gap_share.predict", "unit": "%",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "predict_windows_per_s",
                              "workloads": ["flagship_b96.gapped"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("flagship_b96.gapped", tmp_path / "BENCHMARK.json")
    assert cell.config["name"] == "flagship_b96"
    assert cell.settings == {"batch": 96}
    assert cell.generator().make(cell.traffic["params"], 1, tmp_path) == {"gap_every": 5000}
    assert cell.driver().run(cell, 1, 1, 0, None, tmp_path, 0.0) == {"batch": 96}
    assert [m["name"] for m in cell.per_layer] == ["gap_share.predict"]
    assert cell.metric_reader("gap_share.predict").read({"gap_share": 3.0}) == 3.0
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
