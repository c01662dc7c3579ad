"""On-device window->contig statistical reduction (PyTorch).

Counterpart of `jaeger_tpu/ops/reduce.py`. Instead of shipping every
window's logits to the host, the per-contig sums (logit sum and sum of
squares, per-class argmax counts, entropy/energy sums,
reliability-above-threshold counts) are segment-reduced on the device with
``index_add_``; the host fetches only the partials plus one int8 class per
window. :class:`ContigAccumulator` is a copy of the JAX module's host code.

Window batches arrive ordered by contig; a contig may span batch
boundaries, so partials are keyed by *global* contig index and summed on
the host across batches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def contig_partials(
    logits: torch.Tensor,            # (B, C) float
    seg_ids: torch.Tensor,           # (B,) int, local segment per window
    valid: torch.Tensor,             # (B,) bool
    num_segments: int,
    reliability: torch.Tensor | None = None,   # (B, 1) float
) -> dict[str, torch.Tensor]:
    """Segment partial sums for one batch of windows."""
    z = logits.to(torch.float32)
    vf = valid.to(torch.float32)
    zv = z * vf[:, None]
    seg_ids = seg_ids.to(torch.int64)

    window_cls = torch.argmax(z, dim=-1)

    def seg(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((num_segments,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return out.index_add_(0, seg_ids, x)

    count = seg(vf)
    out = {
        "window_cls": window_cls.to(torch.int8),
        "count": count,
        "sum": seg(zv),
        "sumsq": seg(z * zv),
        "cls_counts": seg(
            F.one_hot(window_cls, z.shape[-1]).to(torch.float32)
            * vf[:, None]),
    }
    # entropy on raw values, clipped like the reference's softmax_entropy
    p = torch.clamp(z, 1e-12, 1.0)
    entropy = -torch.sum(p * torch.log2(p), dim=-1)
    out["entropy_sum"] = seg(entropy * vf)
    # energy: elementwise -log(exp(z)+1) summed over classes, mean on host
    energy = -torch.logaddexp(z, torch.zeros_like(z))
    out["energy_sum"] = seg(torch.sum(energy, dim=-1) * vf)
    out["energy_count"] = count * z.shape[-1]
    if reliability is not None:
        r = reliability.to(torch.float32).reshape(-1)
        above = (torch.sigmoid(r) > 0.5).to(torch.float32)
        out["rel_above"] = seg(above * vf)
        out["rel_count"] = count
    return out


class ContigAccumulator:
    """Host-side accumulation of device partials keyed by global contig."""

    def __init__(self, num_classes: int, with_reliability: bool):
        self.num_classes = num_classes
        self.with_reliability = with_reliability
        self._stats: dict[int, dict[str, np.ndarray]] = {}
        self._window_cls: dict[int, list[np.ndarray]] = {}

    def add_batch(self, partials: dict, contig_base: np.ndarray,
                  window_cls_contigs: np.ndarray | None,
                  window_cls: np.ndarray | None = None) -> None:
        """``contig_base[s]`` = global contig index of local segment s;
        ``window_cls_contigs`` = global contig index per window (None =
        statistics-only batch: the engine's split-mixed execution hands
        the bucket run's per-window classes through the DENSE run's call
        via ``window_cls``, already scattered back into stream order)."""
        counts = np.asarray(partials["count"])
        active = np.nonzero(counts > 0)[0]
        for s in active:
            g = int(contig_base[s])
            st = self._stats.setdefault(g, {})
            for key in ("count", "sum", "sumsq", "cls_counts",
                        "entropy_sum", "energy_sum", "energy_count",
                        "rel_above", "rel_count"):
                if key not in partials:
                    continue
                val = np.asarray(partials[key])[s]
                st[key] = st.get(key, 0) + val
        if window_cls_contigs is None:
            return
        cls = (window_cls if window_cls is not None
               else np.asarray(partials["window_cls"]))[
            : len(window_cls_contigs)]
        for g in np.unique(window_cls_contigs):
            m = window_cls_contigs == g
            self._window_cls.setdefault(int(g), []).append(cls[m])

    def finalize(self) -> dict[int, dict]:
        """Per-contig final stats: mean, var, counts, entropy, energy,
        reliability fraction, window class sequence."""
        out = {}
        for g, st in sorted(self._stats.items()):
            n = max(float(st["count"]), 1.0)
            mean = st["sum"] / n
            var = np.maximum(st["sumsq"] / n - mean * mean, 0.0)
            entry = {
                "n_windows": int(st["count"]),
                "pred_sum": mean.astype(np.float16),
                "pred_var": var.astype(np.float16),
                "cls_counts": st["cls_counts"].astype(np.int64),
                "entropy": np.float16(st["entropy_sum"] / n),
                "energy": np.float16(
                    st["energy_sum"] / max(float(st["energy_count"]), 1.0)
                ),
                "frag_pred": np.concatenate(self._window_cls[g]),
            }
            if self.with_reliability and "rel_above" in st:
                entry["reliability"] = np.float16(
                    st["rel_above"] / max(float(st["rel_count"]), 1.0)
                )
            out[g] = entry
        return out
