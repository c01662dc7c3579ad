"""The profiler's trace of part of the window, and what it says.

:class:`Tracer` starts ``torch.profiler`` (host and device activity) at a
step or batch boundary inside the measured window and stops it at a later
one, each after a ``synchronize`` so the traced range holds whole steps;
the range is a ``bench.traced`` annotation. The trace is exported and
read after the window closes (:meth:`Tracer.finish`). :func:`summarize` reads the
exported Chrome trace: the union of kernels, copies and memsets on the
card inside the range (``busy_s``), its length (``window_s``), the device
time and count of each kernel name, and the idle time of the card split
by the benchmark span that was open on the host (the innermost one;
``outside`` names the time in none of them).
The copy and union logic follows ``chip_smoke.py``'s
``device_busy_share``.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RANGE = "bench.traced"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    kernels: dict = field(default_factory=dict)      # name -> [count, s]
    idle_by_span: dict = field(default_factory=dict)  # span -> s

    def kernel_seconds(self, patterns) -> tuple[float, int]:
        """Device seconds and launches of kernels whose name holds any of
        ``patterns``."""
        s, n = 0.0, 0
        for name, (count, secs) in self.kernels.items():
            if any(p in name for p in patterns):
                s += secs
                n += count
        return s, n

    def top_ops(self, k: int = 10) -> list:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:120], secs] for name, (_, secs) in ranked]

    def top_gaps(self, k: int = 10) -> list:
        ranked = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:k]
        return [[name, secs] for name, secs in ranked]


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, span_names: set, outside: str = "no span") -> TraceSummary:
    ranges = [e for e in events if e.get("name") == RANGE
              and e.get("cat") == "user_annotation"]
    if len(ranges) != 1:
        raise RuntimeError(f"{len(ranges)} {RANGE} ranges in the trace")
    lo = float(ranges[0]["ts"])
    hi = lo + float(ranges[0]["dur"])
    device, kernels, launches = [], defaultdict(lambda: [0, 0.0]), 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), hi)
        if b <= a:
            continue
        device.append((a, b))
        if e["cat"] == "kernel":
            launches += 1
            kernels[e["name"]][0] += 1
            kernels[e["name"]][1] += (b - a) * 1e-6
    busy = _union(device)
    busy_us = sum(b - a for a, b in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") in span_names)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    idle = defaultdict(float)
    for a, b in gaps:
        inside = [(s, t, n) for s, t, n in host if s < b and t > a]
        cuts = sorted({a, b, *[max(s, a) for s, _, _ in inside],
                       *[min(t, b) for _, t, _ in inside]})
        for u, w in zip(cuts, cuts[1:]):
            covering = [(t - s, n) for s, t, n in inside if s <= u and t >= w]
            name = min(covering)[1] if covering else outside
            idle[name] += (w - u) * 1e-6
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
                        launches=launches, kernels=dict(kernels),
                        idle_by_span=dict(idle))


class Tracer:
    """Start and stop the profiler inside the window (``enabled=False``:
    both do nothing and ``summary`` stays None)."""

    def __init__(self, enabled: bool, span_names: set, outside: str):
        self.enabled = enabled
        self.span_names = span_names
        self.outside = outside
        self.summary: TraceSummary | None = None
        self.active = False
        self._prof = self._range = None

    def start(self) -> None:
        if not self.enabled or self.active or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._range = record_function(RANGE)
        self._range.__enter__()
        self.active = True

    def stop(self) -> None:
        """Stop tracing (inside the window); :meth:`finish` reads it."""
        if not self.active:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.active = False

    def finish(self) -> TraceSummary | None:
        """After the window: export the trace and reduce it to
        :attr:`summary`."""
        self.stop()
        if self._prof is None:
            return self.summary
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events, self.span_names, self.outside)
        return self.summary
