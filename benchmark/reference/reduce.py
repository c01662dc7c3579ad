"""What ``predict`` reports for a contig, worked out again from window
logits in NumPy: the class of each window (its best logit, the first on
a tie), the mean of each class's logit in float16, and the share of
windows whose reliability ``sigmoid(r) > 0.5`` (``r > 0``) in float16,
as float32 counts divided."""

from __future__ import annotations

import numpy as np


def contig_reduce(z: np.ndarray, r: np.ndarray | None) -> dict:
    out = {"classes": z.argmax(-1),
           "mean": np.float16(z.astype(np.float64).mean(0)).astype(np.float16)}
    if r is not None:
        out["reliability"] = np.float16(np.float32((r.reshape(-1) > 0).sum())
                                        / np.float32(r.size))
    return out
