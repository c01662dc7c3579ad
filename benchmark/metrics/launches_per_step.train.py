"""Kernel launches on the card per step over the traced steps."""

LAYER = "train loop (train/loop.py)"
UNIT = "launches/step"
MOVES = "train_windows_per_s"


def read(ctx):
    t, steps = ctx["trace"], ctx.get("traced_steps", 0)
    if t is None or not steps:
        return None
    return t.launches / steps
