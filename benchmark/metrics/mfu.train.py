"""The training step's share of the card's peak over the window: three
times the forward's operations of each window trained (forward, data
gradient, weight gradient), counted from the configuration's shapes,
over the window's seconds and the peak of the configuration's
precision."""

from benchmark.harness.peaks import PEAK_FLOPS

LAYER = "model forward and backward (models/builder.py, train/loop.py)"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(ctx):
    if not ctx["windows"]:
        return None
    rate = 3.0 * ctx["flops_per_window"] * ctx["windows"] / ctx["window_s"]
    return 100.0 * rate / PEAK_FLOPS[ctx["settings"]["precision"]]
