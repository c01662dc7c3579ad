"""Host milliseconds each ``jt_pipeline_next`` call of the native windowing
spent blocked on its workers (waiting for the next contig in order): the
pipeline's ``windowing/consumer_wait_ns`` counter over its
``windowing/batches``, as the program counted them over the traced range
(``jaeger_tpu_torch/utils/spans.py``). None where the program has no such
counters."""

LAYER = "host windowing (seqops/windows.py on native/jaeger_host.cpp)"
UNIT = "ms"
MOVES = "predict_windows_per_s"


def read(ctx):
    try:
        from jaeger_tpu_torch.utils import spans
    except ImportError:
        return None
    counters = spans.totals()["counters"]
    if not counters.get("windowing/batches"):
        return None
    return counters["windowing/consumer_wait_ns"] / counters["windowing/batches"] * 1e-6
