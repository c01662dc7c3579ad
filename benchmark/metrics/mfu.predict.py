"""The model's share of the card's peak over the window: the forward's
operations of every window served (counted from the configuration's
shapes, ``harness/flops.py``) over the window's seconds and the peak of
the configuration's precision."""

from benchmark.harness.peaks import PEAK_FLOPS

LAYER = "model forward (models/builder.py::JaegerModel.forward)"
UNIT = "%"
MOVES = "predict_windows_per_s"


def read(ctx):
    if not ctx["windows"]:
        return None
    rate = ctx["flops_per_window"] * ctx["windows"] / ctx["window_s"]
    return 100.0 * rate / PEAK_FLOPS[ctx["settings"]["precision"]]
