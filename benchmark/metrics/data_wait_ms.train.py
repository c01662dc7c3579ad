"""Host milliseconds each step waited on ``batches_from_csv`` (CSV lines
through the shuffle buffer, encoded and one-hot labelled), the
benchmark's span around each ``next()``."""

LAYER = "train data (train/data.py)"
UNIT = "ms"
MOVES = "train_windows_per_s"


def read(ctx):
    return ctx["spans"].mean_ms("train.data")
