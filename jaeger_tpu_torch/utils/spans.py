"""Spans and counters of the program's own host work.

A span names a stretch of host work where it happens (``windowing/next``,
``engine/forward``, ``train/backward``, ``model/residual_block``, ...):

    with spans.span("engine/drain"):
        host = out.cpu()

Spans and counters record only while a ``torch.profiler`` session records
or inside :func:`recording`. Otherwise :func:`span` returns one shared
object whose enter and exit do nothing: it reads no clock, allocates
nothing and calls nothing in torch, so the program pays one flag read a
span. While recording, a span adds its count, its host seconds and its
self seconds (its seconds less those of the spans opened inside it on the
same thread) to totals kept in memory for the process, and under the
profiler it is also a ``torch.profiler.record_function`` range, so the
Chrome trace shows it beside the kernels on the same clock.

:func:`totals` reads the totals, :func:`reset` clears them. ``NAMES``
holds every span and counter name the program uses, but for the
``model/`` spans of the layers. A span never
encloses a ``yield``: it must close on the thread and in the frame that
opened it.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch.autograd.profiler as _autograd_profiler

#: every span and counter name the program opens or adds to, but for the
#: ``model/<layer kind>`` spans, which ``models/builder.py`` names from its
#: layers
NAMES = frozenset({
    # seqops/windows.py on native/jaeger_host.cpp
    "windowing/next",
    "windowing/consumer_wait_ns", "windowing/worker_busy_ns",
    "windowing/worker_capacity_ns", "windowing/batches",
    # infer/engine.py
    "engine/batch", "engine/plan", "engine/pack", "engine/upload",
    "engine/forward", "engine/reduce", "engine/drain", "engine/accumulate",
    # train/loop.py
    "train/forward", "train/backward", "train/optimizer",
    # train/optimizers.py: updates by path (Optimizer.apply)
    "optimizer/fused_updates", "optimizer/leaf_updates",
})

_recording = 0            # open recording() blocks
_lock = threading.Lock()
_local = threading.local()
_spans: dict[str, list] = {}      # name -> [count, seconds, self seconds]
_counters: dict[str, int] = {}


class _Off:
    """The span of a program that is not recording: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "inner", "parent", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.inner = 0.0
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        if self.parent is not None:
            self.parent.inner += seconds
        with _lock:
            rec = _spans.setdefault(self.name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += seconds
            rec[2] += seconds - self.inner
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def active() -> bool:
    """Whether spans and counters record now."""
    return bool(_recording) or _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager timing ``name`` while recording; else the shared
    no-op."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def totals() -> dict:
    """``{"spans": {name: {"count", "seconds", "self_seconds"}},
    "counters": {name: total}}`` of everything recorded since the last
    :func:`reset`."""
    with _lock:
        return {"spans": {k: {"count": c, "seconds": s, "self_seconds": own}
                          for k, (c, s, own) in sorted(_spans.items())},
                "counters": dict(sorted(_counters.items()))}


def reset() -> None:
    """Clear the totals and counters."""
    with _lock:
        _spans.clear()
        _counters.clear()
