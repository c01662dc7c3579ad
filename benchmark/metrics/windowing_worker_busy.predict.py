"""Share of the native windowing's worker time spent on contigs (DUST,
encoding, window rows): the pipeline's ``windowing/worker_busy_ns`` over
``windowing/worker_capacity_ns`` (workers x wall time), as the program
counted them over the traced range (``jaeger_tpu_torch/utils/spans.py``).
None where the program has no such counters."""

LAYER = "host windowing (seqops/windows.py on native/jaeger_host.cpp)"
UNIT = "%"
MOVES = "predict_windows_per_s"


def read(ctx):
    try:
        from jaeger_tpu_torch.utils import spans
    except ImportError:
        return None
    counters = spans.totals()["counters"]
    if not counters.get("windowing/worker_capacity_ns"):
        return None
    return 100.0 * counters["windowing/worker_busy_ns"] / counters["windowing/worker_capacity_ns"]
