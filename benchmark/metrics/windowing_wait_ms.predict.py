"""Host milliseconds the engine waited on ``window_batches`` for each
batch of windows (the benchmark's span around each ``next()``; the
native pipeline's reader and workers run ahead of it)."""

LAYER = "host windowing (seqops/windows.py on native/jaeger_host.cpp)"
UNIT = "ms"
MOVES = "predict_windows_per_s"


def read(ctx):
    return ctx["spans"].mean_ms("windowing")
