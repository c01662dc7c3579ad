"""Host milliseconds from the step call to its return (the dispatcher's
plan, the upload, the forward, backward and optimizer launches; the step
does not wait for the card), the benchmark's span around each call."""

LAYER = "train loop (train/loop.py)"
UNIT = "ms"
MOVES = "train_windows_per_s"


def read(ctx):
    return ctx["spans"].mean_ms("train.step")
