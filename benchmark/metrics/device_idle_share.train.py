"""Share of the traced range in which no kernel, copy or memset ran on
the card."""

LAYER = "device"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
