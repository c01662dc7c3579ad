"""Host milliseconds to enqueue one forward (the device unpack of the bases
and the model's launches, which do not wait for the card), the program's
span ``engine/forward``, per span over the traced range
(``jaeger_tpu_torch/utils/spans.py``). None where the program has no
such span."""

LAYER = "engine (infer/engine.py)"
UNIT = "ms/forward"
MOVES = "predict_windows_per_s"


def read(ctx):
    try:
        from jaeger_tpu_torch.utils import spans
    except ImportError:
        return None
    span = spans.totals()["spans"].get("engine/forward")
    if not span or not span["count"]:
        return None
    return span["seconds"] / span["count"] * 1e3
