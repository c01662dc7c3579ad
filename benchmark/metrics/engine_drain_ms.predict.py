"""Host milliseconds the engine waited for an earlier batch's outputs to
reach the host (the ``.cpu()`` copies in ``drain_one``, one drain a
batch), the program's span ``engine/drain``, per span over the traced
range (``jaeger_tpu_torch/utils/spans.py``). None where the program has
no such span."""

LAYER = "engine (infer/engine.py)"
UNIT = "ms/batch"
MOVES = "predict_windows_per_s"


def read(ctx):
    try:
        from jaeger_tpu_torch.utils import spans
    except ImportError:
        return None
    span = spans.totals()["spans"].get("engine/drain")
    if not span or not span["count"]:
        return None
    return span["seconds"] / span["count"] * 1e3
