"""A cell's parts, found by the names ``BENCHMARK.json`` gives them.

* ``configs[i].file``: the configuration as it is run (its ``model`` and
  ``training`` sections and the ``predict`` / ``train`` run settings);
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, naming its
  ``driver`` (``benchmark/drivers/<driver>.py``) and its ``generator``
  (``benchmark/generators/<generator>.py``);
* ``benchmark/limits/<workload>.json``: the limit of each number compared;
* ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a cell by adding files and entries; none of these
files is edited for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

#: the checkout's root (the directory that holds ``BENCHMARK.json``)
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_module(path: Path, name: str):
    """A module from a file (names here may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload with everything it names, resolved."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = BENCH

    @property
    def settings(self) -> dict:
        """Run settings of the driver: the configuration's section named
        after it."""
        return self.config[self.traffic["driver"]]

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['driver']}.py",
                           f"bench_driver_{self.traffic['driver']}")

    def generator(self):
        gen = self.traffic["generator"]
        return load_module(self.root / "generators" / f"{gen}.py",
                           f"bench_generator_{gen}")

    def metric_reader(self, name: str):
        return load_module(self.root / "metrics" / f"{name}.py",
                           "bench_metric_" + name.replace(".", "_"))


def _applies(metric: dict, workload: str, reported: set[str] | None = None) -> bool:
    cells = metric.get("workloads")
    if cells is not None:
        return workload in cells
    return reported is None or metric.get("moves") in reported


def load_cell(workload: str, spec_path: Path | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``."""
    spec_path = spec_path or ROOT / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    root = spec_path.parent
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in {spec_path}")
    w = found[0]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload, reported)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer, root=bench)
