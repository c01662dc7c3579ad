"""The benchmark's own spans around calls into the program's layers.

A :class:`Spans` records, for each name, how many times a span opened and
the host seconds it lasted (two reads of the host clock); with
``trace=True`` each span is also a ``torch.profiler.record_function``
range, so the profiler's trace names the host's work beside the device's.
``wrap`` puts a span around a callable; :func:`patched` swaps attributes
for the length of a block.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, trace: bool):
        self.trace = trace
        self.seconds: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            if self.trace:
                from torch.profiler import record_function

                with record_function(name):
                    yield
            else:
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.count[name] += 1

    def totals(self) -> dict:
        """{name: [count, seconds]} of every span."""
        return {k: [self.count[k], self.seconds[k]] for k in sorted(self.seconds)}

    def wrap(self, name: str, fn):
        def wrapper(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapper

    def mean_ms(self, name: str) -> float | None:
        """Milliseconds per span, None if unseen."""
        n = self.count.get(name, 0)
        if not n:
            return None
        return self.seconds[name] / n * 1e3


@contextlib.contextmanager
def patched(pairs):
    """Set ``setattr(owner, attr, value)`` for each triple, restore after."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in pairs]
    for owner, attr, value in pairs:
        setattr(owner, attr, value)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
