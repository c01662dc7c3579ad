"""The port's spans and counters (``jaeger_tpu_torch/utils/spans.py``) and
where the program opens them: off they cost one flag read and touch
neither the clock nor the profiler; on, under ``torch.profiler`` or
``spans.recording()``, they nest per thread, give each span its self
time, and appear in the Chrome trace as ``user_annotation`` ranges; the
native windowing pipeline, the engine and a dispatching train step open
theirs once a batch or step, each layer its ``model/<kind>``; every
fixed name the program uses is in ``NAMES`` and every name in ``NAMES``
is used."""

import json
import math
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
import yaml
from torch.profiler import ProfilerActivity, profile

from jaeger_tpu_torch import native
from jaeger_tpu_torch.models import builder
from jaeger_tpu_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "data" / "tiny_config.yaml"


@pytest.fixture(autouse=True)
def _clean_totals():
    spans.reset()
    yield
    spans.reset()


def _boom(*args, **kwargs):
    raise AssertionError("called while spans are off")


def _tiny_model():
    torch.manual_seed(0)
    return builder.build_model(yaml.safe_load(TINY.read_text()))


def _windows(rng, crop: int, n: int, masked_every: int):
    """``n`` full windows, every ``masked_every``-th with an N: one masked
    row in each batch of that size, so each runs split (a bucket and the
    base program)."""
    from jaeger_tpu_torch.seqops.windows import WindowBatch

    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    bases[::masked_every, crop // 2] = 4
    zeros = np.zeros(n, np.int32)
    return WindowBatch(bases=bases, length=np.full(n, crop, np.int32),
                       contig=np.arange(n, dtype=np.int32) // 3, start=zeros,
                       contig_end=(np.arange(n) % 3 == 2).astype(np.int8),
                       ordinal=zeros, seqlen=np.full(n, crop, np.int32), g=zeros,
                       c=zeros, a=zeros, t=zeros, gc_skew=np.zeros(n, np.float32),
                       headers=[f"w{i}" for i in range(n)])


def _trace_events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"]


def _within(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_off_is_the_shared_noop_and_touches_no_clock_or_profiler(monkeypatch):
    assert not spans.active()
    monkeypatch.setattr(time, "perf_counter", _boom)
    monkeypatch.setattr(autograd_profiler, "record_function", _boom)
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    first, second = spans.span("engine/plan"), spans.span("engine/batch")
    assert first is second
    with first:
        spans.count("windowing/batches", 3)
    # the program's own spans, all off: a batch through the engine and a
    # forward of the model
    from jaeger_tpu_torch.infer.engine import InferenceEngine

    model = _tiny_model()
    engine = InferenceEngine(model, batch_size=8, device="cpu")
    batch = _windows(np.random.default_rng(0), model.crop_nt, 16, 8)
    engine.predict_batches_reduced([batch], num_classes=3)
    assert spans.totals() == {"spans": {}, "counters": {}}


def test_nested_spans_under_the_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.active()
        with spans.span("engine/batch"):
            time.sleep(0.002)
            with spans.span("engine/plan"):
                time.sleep(0.003)
            with spans.span("engine/drain"):
                time.sleep(0.001)
    assert not spans.active()
    t = spans.totals()["spans"]
    assert {k: v["count"] for k, v in t.items()} == {
        "engine/batch": 1, "engine/plan": 1, "engine/drain": 1}
    outer = t["engine/batch"]
    assert math.isclose(outer["self_seconds"],
                        outer["seconds"] - t["engine/plan"]["seconds"]
                        - t["engine/drain"]["seconds"], rel_tol=1e-9)
    assert outer["self_seconds"] >= 0.002 and outer["seconds"] >= 0.006
    for child in ("engine/plan", "engine/drain"):
        assert t[child]["self_seconds"] == t[child]["seconds"]
    events = {e["name"]: e for e in _trace_events(prof, tmp_path)
              if e["name"].startswith("engine/")}
    assert set(events) == {"engine/batch", "engine/plan", "engine/drain"}
    assert _within(events["engine/plan"], events["engine/batch"])
    assert _within(events["engine/drain"], events["engine/batch"])
    assert not _within(events["engine/plan"], events["engine/drain"])


def test_recording_without_a_profiler(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _boom)
    with spans.recording():
        assert spans.active()
        with spans.span("engine/batch"):
            with spans.span("engine/plan"):
                pass
        spans.count("windowing/batches", 2)
        spans.count("windowing/batches")
    assert not spans.active()
    with spans.span("engine/batch"):
        pass
    got = spans.totals()
    assert got["counters"] == {"windowing/batches": 3}
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "engine/batch": 1, "engine/plan": 1}
    spans.reset()
    assert spans.totals() == {"spans": {}, "counters": {}}


def test_threads_keep_their_own_stack_and_lose_no_update():
    threads_n, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with spans.span("engine/batch"):
                    with spans.span("engine/plan"):
                        pass
                    spans.count("windowing/batches")

        with spans.recording():
            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = spans.totals()
    assert got["counters"]["windowing/batches"] == threads_n * rounds
    outer = got["spans"]["engine/batch"]
    assert outer["count"] == got["spans"]["engine/plan"]["count"] == threads_n * rounds
    assert math.isclose(outer["self_seconds"],
                        outer["seconds"] - got["spans"]["engine/plan"]["seconds"],
                        rel_tol=1e-6)


def test_native_pipeline_counts_its_waits_and_work(tmp_path):
    from jaeger_tpu_torch.seqops.windows import window_batches

    assert native.available()
    rng = np.random.default_rng(4)
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(
        f">c{i}\n{''.join(rng.choice(list('ACGT'), size=int(rng.integers(2000, 9000))))}\n"
        for i in range(40)))
    kw = dict(fragsize=300, stride=300, min_len=300, workers=2, batch_capacity=128)
    want = list(window_batches(str(fasta), **kw))
    assert not spans.totals()["counters"]
    with spans.recording():
        got = list(window_batches(str(fasta), **kw))
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.bases, b.bases)
        assert a.headers == b.headers
    t = spans.totals()
    assert t["spans"]["windowing/next"]["count"] == len(got)
    c = t["counters"]
    assert c["windowing/batches"] == len(got)
    assert c["windowing/consumer_wait_ns"] > 0 and c["windowing/worker_busy_ns"] > 0
    # two workers cannot be busy for longer than two workers' wall time
    assert c["windowing/worker_busy_ns"] <= c["windowing/worker_capacity_ns"]


def test_engine_opens_one_batch_span_a_batch_with_drains_inside(tmp_path):
    from jaeger_tpu_torch.infer.engine import PIPELINE_DEPTH, InferenceEngine

    model = _tiny_model()
    bs, n = 16, 16 * (PIPELINE_DEPTH + 3)
    engine = InferenceEngine(model, batch_size=bs, device="cpu",
                             output_keys=("prediction",))
    batch = _windows(np.random.default_rng(1), model.crop_nt, n, bs)
    want, _ = engine.predict_batches_reduced([batch], num_classes=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, _ = engine.predict_batches_reduced([batch], num_classes=3)
    assert got.keys() == want.keys()
    for contig, stats in want.items():
        for key, value in stats.items():
            np.testing.assert_array_equal(got[contig][key], value)
    batches = n // bs
    t = spans.totals()["spans"]
    for name in ("engine/batch", "engine/plan", "engine/drain", "engine/accumulate"):
        assert t[name]["count"] == batches, name
    # the split batches run two forwards, a bucket and the base
    assert t["engine/forward"]["count"] == t["engine/pack"]["count"] == 2 * batches
    assert t["engine/reduce"]["count"] == t["engine/forward"]["count"]
    assert 0 < t["engine/batch"]["self_seconds"] < t["engine/batch"]["seconds"]
    events = _trace_events(prof, tmp_path)
    outer = [e for e in events if e["name"] == "engine/batch"]
    drains = [e for e in events if e["name"] == "engine/drain"]
    assert len(outer) == batches
    inside = [d for d in drains if any(_within(d, o) for o in outer)]
    assert len(inside) == batches - PIPELINE_DEPTH
    forwards = [e for e in events if e["name"] == "engine/forward"]
    assert all(any(_within(e, f) for f in forwards)
               for e in events if e["name"].startswith("model/"))
    assert {"model/encode", "model/masked_conv1d", "model/activation",
            "model/pooling", "model/heads", "model/dense"} <= {e["name"] for e in events}


def test_dispatching_train_step_opens_each_phase_once():
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    model = _tiny_model().train()
    state = loop.TrainState.create(model, make_optimizer("adam", {"learning_rate": 1e-3}))
    step = loop.make_dispatching_train_step(
        model, loop.StepConfig(heads=("prediction",)), "cpu")
    rng = np.random.default_rng(3)
    crop = model.crop_nt
    batch = {"bases": rng.integers(0, 4, size=(6, crop)).astype(np.uint8),
             "lengths": np.full(6, crop, np.int32),
             "labels": np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=6)]}
    step(state, batch)                       # the program's first step
    with spans.recording():
        state, metrics = step(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    t = spans.totals()["spans"]
    assert set(t) == {"train/forward", "train/backward", "train/optimizer"} | {
        name for name in t if name.startswith("model/")}
    for name in ("train/forward", "train/backward", "train/optimizer"):
        assert t[name]["count"] == 1, name
    # the three phases follow one another: the model's spans nest in the
    # forward, nothing in the backward or the optimizer
    assert t["train/forward"]["self_seconds"] < t["train/forward"]["seconds"]
    for name in ("train/backward", "train/optimizer"):
        assert t[name]["self_seconds"] == t[name]["seconds"], name


def test_layer_spans_are_named_by_layer_kind():
    """Each layer of a stack opens ``model/<its kind>`` (an activation
    layer ``model/activation``), whatever kinds the builder knows."""
    model = _tiny_model().eval()
    kinds = {("activation" if name in builder._ACT_LAYERS else name)
             for stack in model.modules() if isinstance(stack, builder.LayerStack)
             for name, _ in stack.layer_configs}
    assert {"masked_conv1d", "activation", "dense"} <= kinds
    bases = torch.randint(0, 4, (2, model.crop_nt), dtype=torch.uint8)
    lengths = torch.full((2,), model.crop_nt, dtype=torch.int32)
    with spans.recording(), torch.no_grad():
        model(bases, lengths)
    opened = set(spans.totals()["spans"])
    assert {f"model/{kind}" for kind in kinds} <= opened
    assert {"model/encode", "model/heads"} <= opened
    assert all(name.startswith("model/") for name in opened)


_OPENED = re.compile(
    r"""(?:\bspans\.(?:span|count)|(?<![\w.])span)\(\s*["']([^"']+)["']""")


def test_every_name_the_program_opens_is_in_names_and_each_is_used():
    """``NAMES`` is every fixed name the program opens or counts; the
    layers' spans are ``model/...``, named by the builder."""
    found = set()
    for path in (ROOT / "jaeger_tpu_torch").rglob("*.py"):
        found |= set(_OPENED.findall(path.read_text()))
    assert found, "no span found in the program"
    layer_spans = {name for name in found if name.startswith("model/")}
    assert layer_spans, "the builder opens no layer span"
    assert not {name for name in spans.NAMES if name.startswith("model/")}
    assert spans.NAMES == found - layer_spans
