"""The trace reduction and the per-layer readers on a small canned Chrome
trace and canned spans."""

import math

import pytest

from benchmark.harness.cell import ROOT, load_cell, load_module
from benchmark.harness.spans import Spans
from benchmark.harness.trace import summarize

K1 = "void conv_bf16_wgmma<128, 5>(Params, Layout, CUtensorMap)"
K2 = "void at::native::elementwise_kernel<128, 2>(int)"


def _events():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return [
        x("bench.traced", "user_annotation", 1000.0, 1000.0),
        x("engine.plan", "user_annotation", 1000.0, 100.0),
        x("windowing", "user_annotation", 1500.0, 250.0),
        x(K1, "kernel", 1100.0, 300.0),        # busy 1100-1400
        x(K2, "kernel", 1350.0, 100.0),        # busy to 1450
        x("Memcpy HtoD", "gpu_memcpy", 1800.0, 50.0),
        x(K1, "kernel", 1900.0, 200.0),        # clipped at 2000
        x(K2, "kernel", 500.0, 100.0),         # outside the range
        x("cudaLaunchKernel", "cuda_runtime", 1100.0, 5.0),
    ]


def test_summarize_busy_idle_and_kernels():
    t = summarize(_events(), {"engine.plan", "windowing"}, outside="engine.drain")
    assert math.isclose(t.window_s, 1000e-6)
    assert math.isclose(t.busy_s, (350 + 50 + 100) * 1e-6)
    assert t.launches == 3
    assert t.kernels[K1][0] == 2 and math.isclose(t.kernels[K1][1], 400e-6)
    assert math.isclose(t.kernel_seconds(("conv_bf16_wgmma",))[0], 400e-6)
    idle = t.idle_by_span
    assert math.isclose(idle["engine.plan"], 100e-6)
    assert math.isclose(idle["windowing"], 250e-6)
    assert math.isclose(idle["engine.drain"], (50 + 50 + 50) * 1e-6)
    assert math.isclose(sum(idle.values()) + t.busy_s, t.window_s)
    assert t.top_ops(1)[0][0] == K1[:120]
    assert t.top_gaps(1)[0][0] == "windowing"


def test_summarize_needs_one_range():
    with pytest.raises(RuntimeError):
        summarize([e for e in _events() if e["name"] != "bench.traced"], set())


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", name)


def _spans(**secs_counts):
    s = Spans(trace=False)
    for name, (secs, n) in secs_counts.items():
        s.seconds[name] = secs
        s.count[name] = n
    return s


def test_predict_readers():
    cell = load_cell("flagship.predict")
    t = summarize(_events(), {"engine.plan", "windowing"})
    ctx = {"spans": _spans(windowing=(0.02, 10), **{"engine.plan": (0.01, 5),
                                                    "engine.pack": (0.02, 10),
                                                    "engine.upload": (0.03, 30)}),
           "trace": t, "traced_forwards": {(2048, "dense"): 1},
           "windows": 20000, "window_s": 1.0, "flops_per_window": 4e9,
           "model_cfg": cell.config["model"], "settings": cell.settings}
    assert math.isclose(_reader("windowing_wait_ms.predict").read(ctx), 2.0)
    assert math.isclose(_reader("engine_host_ms.predict").read(ctx), 12.0)
    assert math.isclose(_reader("mfu.predict").read(ctx), 100 * 8e13 / 989e12)
    assert math.isclose(_reader("device_idle_share.predict").read(ctx), 50.0)
    bound = _reader("conv_fwd_roofline.predict").forward_bound_s(
        cell.config["model"], 2048, False, "bfloat16")
    assert math.isclose(_reader("conv_fwd_roofline.predict").read(ctx),
                        100 * bound / 400e-6)


def test_train_readers():
    cell = load_cell("flagship.train")
    t = summarize(_events(), {"engine.plan", "windowing"})
    ctx = {"spans": _spans(**{"train.data": (0.03, 10), "train.step": (0.4, 10)}),
           "trace": t, "traced_steps": 3, "batch": 256, "windows": 256 * 100,
           "window_s": 5.0, "flops_per_window": 4e9, "model_cfg": cell.config["model"],
           "settings": cell.settings}
    assert math.isclose(_reader("data_wait_ms.train").read(ctx), 3.0)
    assert math.isclose(_reader("host_ms_per_step.train").read(ctx), 40.0)
    assert math.isclose(_reader("launches_per_step.train").read(ctx), 1.0)
    assert math.isclose(_reader("mfu.train").read(ctx), 100 * 3 * 4e9 * 5120 / 989e12)
    assert math.isclose(_reader("device_idle_share.train").read(ctx), 50.0)
    bound = _reader("conv_roofline.train").step_bound_s(cell.config["model"], 256,
                                                        "bfloat16")
    assert math.isclose(_reader("conv_roofline.train").read(ctx), 100 * 3 * bound / 400e-6)


@pytest.mark.parametrize("name", ["conv_fwd_roofline.predict", "device_idle_share.predict",
                                  "launches_per_step.train", "conv_roofline.train"])
def test_readers_without_a_trace_read_nothing(name):
    ctx = {"trace": None, "traced_steps": 0, "traced_forwards": {}}
    assert _reader(name).read(ctx) is None
