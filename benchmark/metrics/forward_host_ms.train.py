"""Host milliseconds a training step spends enqueueing its forward (the
model, the loss and the regularizer), the program's span
``train/forward``, per span over the traced range
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
    span = spans.totals()["spans"].get("train/forward")
    if not span or not span["count"]:
        return None
    return span["seconds"] / span["count"] * 1e3
