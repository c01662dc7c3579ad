"""Host milliseconds of the engine's own work per batch: the program plan
(``_plan_batch``), the nibble packing (``pack_bases``) and the pinned
copies and enqueue (``_to_device``), over the batches planned."""

LAYER = "engine (infer/engine.py)"
UNIT = "ms"
MOVES = "predict_windows_per_s"


def read(ctx):
    spans = ctx["spans"]
    batches = spans.count.get("engine.plan", 0)
    if not batches:
        return None
    secs = sum(spans.seconds.get(k, 0.0)
               for k in ("engine.plan", "engine.pack", "engine.upload"))
    return secs / batches * 1e3
