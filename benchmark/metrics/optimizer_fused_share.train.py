"""Share of the training steps' optimizer updates that took the fused
Adam / AdamW kernel pair: the program's ``optimizer/fused_updates`` over
those and ``optimizer/leaf_updates`` (the per-leaf update), as
``Optimizer.apply`` counted them over the traced range
(``jaeger_tpu_torch/utils/spans.py``). None where the program has no
such counters."""

LAYER = "train loop (train/loop.py)"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(ctx):
    try:
        from jaeger_tpu_torch.utils import spans
    except ImportError:
        return None
    counters = spans.totals()["counters"]
    fused = counters.get("optimizer/fused_updates", 0)
    total = fused + counters.get("optimizer/leaf_updates", 0)
    if not total:
        return None
    return 100.0 * fused / total
