"""The readers of the program's own spans and counters
(``jaeger_tpu_torch/utils/spans.py``): canned totals give the documented
values, no totals or no such module give None, a tiny traced run of each
cell on the CPU gives every one of them, and the program's inner spans
time the same calls as the benchmark's own spans around them. No file
the benchmark had before them changed."""

import contextlib
import hashlib
import json
import math
import sys
import time

import pytest
import torch

from benchmark.harness.cell import ROOT, load_module
from benchmark.harness.main import run_cell
from benchmark.harness.spans import Spans
from jaeger_tpu_torch.utils import spans

NEW = {"flagship.predict": ["windowing_stall_ms.predict", "windowing_worker_busy.predict",
                            "engine_drain_ms.predict", "forward_enqueue_ms.predict"],
       "flagship.train": ["forward_host_ms.train", "backward_host_ms.train",
                          "optimizer_host_ms.train"]}
ALL_NEW = [m for names in NEW.values() for m in names]

CANNED = {
    "spans": {"engine/drain": {"count": 4, "seconds": 0.02, "self_seconds": 0.02},
              "engine/forward": {"count": 8, "seconds": 0.06, "self_seconds": 0.01},
              "train/forward": {"count": 5, "seconds": 0.05, "self_seconds": 0.01},
              "train/backward": {"count": 5, "seconds": 0.1, "self_seconds": 0.1},
              "train/optimizer": {"count": 5, "seconds": 0.04, "self_seconds": 0.04}},
    "counters": {"windowing/batches": 4, "windowing/consumer_wait_ns": 200_000_000,
                 "windowing/worker_busy_ns": 3_000_000_000,
                 "windowing/worker_capacity_ns": 4_000_000_000},
}
READS = {"windowing_stall_ms.predict": 50.0, "windowing_worker_busy.predict": 75.0,
         "engine_drain_ms.predict": 5.0, "forward_enqueue_ms.predict": 7.5,
         "forward_host_ms.train": 10.0, "backward_host_ms.train": 20.0,
         "optimizer_host_ms.train": 8.0}


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


@pytest.fixture(autouse=True)
def _clean_totals():
    spans.reset()
    yield
    spans.reset()


@pytest.mark.parametrize("name", ALL_NEW)
def test_reader_reads_canned_totals(monkeypatch, name):
    monkeypatch.setattr(spans, "totals", lambda: CANNED)
    assert math.isclose(_reader(name).read({}), READS[name])


@pytest.mark.parametrize("name", ALL_NEW)
def test_reader_without_totals_reads_nothing(name):
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("name", ALL_NEW)
def test_reader_of_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "jaeger_tpu_torch.utils.spans", None)
    assert _reader(name).read({}) is None


def _run(cell, trace: bool = True):
    torch.set_num_threads(1)
    if trace:
        # a process's first profiler takes about a second to start: start
        # one before the run, so the tiny run's 3 s window keeps its whole
        # traced range
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pass
    result, _, own = run_cell(cell, 2**31 + 77, 3.0, trace, torch.device("cpu"),
                              time.perf_counter())
    return result, own


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_run_reads_the_new_metrics(tiny_cell, workload):
    """The profiler alone turns the program's spans on: the traced range
    of a tiny run gives each new metric of the cell (and no other cell's)."""
    result, _ = _run(tiny_cell(workload))
    metrics = result["metrics"]
    assert set(NEW[workload]) <= set(metrics)
    assert not set(ALL_NEW) - set(NEW[workload]) & set(metrics)
    assert all(math.isfinite(metrics[m]["value"]) and metrics[m]["value"] > 0
               for m in NEW[workload])
    names = set(spans.totals()["spans"])
    assert {name for name in names if not name.startswith("model/")} <= spans.NAMES
    assert not names & {name for name, _ in result["breakdown"]["idle_gaps"]}


@pytest.mark.parametrize("workload,inner,outer,trace", [
    ("flagship.predict", ("engine/plan",), "engine.plan", False),
    ("flagship.train", ("train/forward", "train/backward", "train/optimizer"),
     "train.step", True)])
def test_inner_spans_time_what_the_benchmark_spans_time(tiny_cell, monkeypatch, workload,
                                                        inner, outer, trace):
    """With the program recording exactly while a benchmark span is open,
    each inner span counts the same calls, and together they take 80 to
    100 % of the benchmark's span around them (a step's program choice
    and upload are left to the train step's three phases). The plan's
    run is untraced: a tiny plan takes about 0.1 ms on the CPU, and a
    traced run's benchmark span opens a profiler range on every call,
    which costs about as much again."""
    around = Spans.span

    @contextlib.contextmanager
    def recording_span(self, name):
        with spans.recording(), around(self, name):
            yield

    monkeypatch.setattr(Spans, "span", recording_span)
    _, own = _run(tiny_cell(workload), trace)
    count, seconds = own["host_spans"][outer]
    got = spans.totals()["spans"]
    assert count > 0
    assert all(got[name]["count"] == count for name in inner)
    total = sum(got[name]["seconds"] for name in inner)
    assert 0.8 * seconds <= total <= seconds


#: sha256 (first 16 hex digits) of every file of ``benchmark/`` before the
#: program's spans were read
BEFORE = {
    "README.md": "adb62bce3f3e744b",
    "__init__.py": "4d892ceeeb9c0ce6",
    "configs/flagship.json": "350459c877ea9d01",
    "controls.py": "f8554df619292542",
    "drivers/predict.py": "e5bb186b518ccbbc",
    "drivers/train.py": "e594348d2b013b7b",
    "generators/assembly.py": "c411ff0970bd6215",
    "generators/fragments.py": "8645dc170e67a4f0",
    "harness/__init__.py": "67ce4d032808a412",
    "harness/cell.py": "223cc010872a48b6",
    "harness/flops.py": "c1817d85f80bb1e5",
    "harness/main.py": "bdd629b7dde6d0ac",
    "harness/peaks.py": "5f6d6af9be2efac4",
    "harness/program.py": "3ec86c91c52b553b",
    "harness/spans.py": "de42de562ff9bfa1",
    "harness/trace.py": "647b374958bec56b",
    "harness/weights.py": "4912cd97572d0df4",
    "limits/flagship.predict.json": "1f873135eada034c",
    "limits/flagship.train.json": "1ac170ffc03fa433",
    "metrics/conv_fwd_roofline.predict.py": "81c9edf77196e321",
    "metrics/conv_roofline.train.py": "3af722dcc0ba8637",
    "metrics/data_wait_ms.train.py": "c41e82fcc9de4458",
    "metrics/device_idle_share.predict.py": "747c2eeeb442b951",
    "metrics/device_idle_share.train.py": "356be83ae24ffeef",
    "metrics/engine_host_ms.predict.py": "1d6d4cda5adc743a",
    "metrics/host_ms_per_step.train.py": "3cb3872a16c8e5a8",
    "metrics/launches_per_step.train.py": "6b9df33c0f54c139",
    "metrics/mfu.predict.py": "d4f0513be117bd45",
    "metrics/mfu.train.py": "f42228523ed39d94",
    "metrics/windowing_wait_ms.predict.py": "b4780dab9f995cba",
    "reference/__init__.py": "0cba6fdccca7d8ec",
    "reference/judge.py": "49126c660a1e7b3b",
    "reference/model.py": "eeea149d6d5f24e3",
    "reference/reduce.py": "a953bc307b9c6e2b",
    "reference/train.py": "99bc0f2aec4a137f",
    "reference/windows.py": "93b975bf24fa7723",
    "run.py": "f6b832ca918999d7",
    "tests/conftest.py": "51b1e6986edf6734",
    "tests/data/crossframe.json": "4847b0876dc0aadb",
    "tests/test_bench_control.py": "25ae8ee8e6e249b4",
    "tests/test_bench_counts.py": "ff7e84115a56efa0",
    "tests/test_bench_discovery.py": "cc66c983b5dede1c",
    "tests/test_bench_faults.py": "8ff81e97c7aae7a7",
    "tests/test_bench_generators.py": "5872fe97aa939c64",
    "tests/test_bench_imports.py": "20bf359533a48b54",
    "tests/test_bench_nocard.py": "0ea87e270bb98a77",
    "tests/test_bench_readers.py": "65251b41277d9d98",
    "tests/test_bench_reference.py": "099c5578b28372ae",
    "traffic/assembly.json": "50784ddc9c9edb81",
    "traffic/fragments.json": "eec3c0211b64326a",
}
#: the same of ``BENCHMARK.json``'s entries then (each list's first entries,
#: each metric's ``workloads`` cut to its one cell then: later cells may be
#: appended), as sorted JSON
SPEC_BEFORE = "c422a88a33bc6f66"
SPEC_LENGTHS = {"configs": 1, "workloads": 2, "end_to_end": 3, "per_layer": 11}


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def test_no_benchmark_file_changed():
    bench = ROOT / "benchmark"
    assert {k: _digest((bench / k).read_bytes()) for k in BEFORE} == BEFORE


def test_the_spec_changed_only_by_additions():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, n in SPEC_LENGTHS.items():
        spec[key] = [dict(e, **({"workloads": e["workloads"][:1]} if "workloads" in e else {}))
                     for e in spec[key][:n]]
    assert _digest(json.dumps(spec, sort_keys=True).encode()) == SPEC_BEFORE
