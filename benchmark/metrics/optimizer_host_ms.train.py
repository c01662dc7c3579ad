"""Host milliseconds a training step spends in the optimizer (the update,
its in-place adds and the gradient norm), the program's span
``train/optimizer``, per span over the traced range
(``jaeger_tpu_torch/utils/spans.py``). None where the program has no
such span."""

LAYER = "train loop (train/loop.py)"
UNIT = "ms/step"
MOVES = "train_windows_per_s"


def read(ctx):
    try:
        from jaeger_tpu_torch.utils import spans
    except ImportError:
        return None
    span = spans.totals()["spans"].get("train/optimizer")
    if not span or not span["count"]:
        return None
    return span["seconds"] / span["count"] * 1e3
