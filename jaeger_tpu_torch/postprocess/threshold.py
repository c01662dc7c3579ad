"""Copy of `jaeger_tpu/postprocess/threshold.py`.

Reliability-threshold tuning and calibration.

Parity target: reference ``postprocess/threshold.py:176-362`` — sweep a
cutoff grid over reliability scores with f1-id / f1-ood / Youden / MCC
selection, AUROC/AUPRC summary, ECE + Brier calibration bins, and the
``reliability_threshold.txt`` / sweep / calibration CSV outputs.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Iterable

import numpy as np

SUPPORTED_METRICS = ("f1-id", "f1-ood", "youden", "mcc")


def _f1(labels, preds, pos_label: int) -> float:
    tp = int(np.sum((preds == pos_label) & (labels == pos_label)))
    fp = int(np.sum((preds == pos_label) & (labels != pos_label)))
    fn = int(np.sum((preds != pos_label) & (labels == pos_label)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def _auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]))
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ties
    allv = np.concatenate([pos, neg])
    for v in np.unique(allv):
        m = allv == v
        ranks[m] = ranks[m].mean()
    r_pos = ranks[: len(pos)].sum()
    auc = (r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg))
    return float(auc)


def _auprc(labels: np.ndarray, scores: np.ndarray) -> float:
    if labels.sum() == 0:
        return float("nan")
    order = np.argsort(-scores)
    sorted_labels = labels[order]
    tp = np.cumsum(sorted_labels)
    precision = tp / np.arange(1, len(labels) + 1)
    recall = tp / labels.sum()
    # average precision
    dr = np.diff(np.concatenate([[0.0], recall]))
    return float(np.sum(precision * dr))


def tune_reliability_threshold(
    scores: np.ndarray,
    labels: np.ndarray,
    metric: str = "f1-id",
    min_threshold: float = 0.0,
    max_threshold: float = 0.95,
    step: float = 0.05,
) -> tuple[float, list[dict[str, float]], dict[str, float]]:
    """Grid sweep -> (best_threshold, per-threshold rows, auroc/auprc)."""
    if metric not in SUPPORTED_METRICS:
        raise ValueError(
            f"unsupported metric {metric!r}; choose from {SUPPORTED_METRICS}"
        )
    scores = np.asarray(scores, np.float32).reshape(-1)
    labels = np.asarray(labels, np.int32).reshape(-1)
    if scores.shape[0] != labels.shape[0]:
        raise ValueError("scores/labels length mismatch")
    if np.unique(labels).size < 2:
        raise ValueError(
            "threshold tuning requires both ID (1) and OOD (0) labels"
        )

    rows: list[dict[str, float]] = []
    for threshold in np.arange(min_threshold, max_threshold + step, step):
        preds = (scores >= threshold).astype(np.int32)
        tp = int(np.sum((preds == 1) & (labels == 1)))
        tn = int(np.sum((preds == 0) & (labels == 0)))
        fp = int(np.sum((preds == 1) & (labels == 0)))
        fn = int(np.sum((preds == 0) & (labels == 1)))
        tpr = tp / (tp + fn) if (tp + fn) else 0.0
        tnr = tn / (tn + fp) if (tn + fp) else 0.0
        denom = math.sqrt(
            (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
        )
        rows.append({
            "threshold": float(threshold),
            "f1_id": _f1(labels, preds, 1),
            "f1_ood": _f1(labels, preds, 0),
            "youden_j": float(tpr + tnr - 1.0),
            "mcc": (tp * tn - fp * fn) / denom if denom > 0 else 0.0,
        })

    metric_key = {"f1-id": "f1_id", "f1-ood": "f1_ood",
                  "youden": "youden_j", "mcc": "mcc"}[metric]
    best_idx = int(np.argmax([r[metric_key] for r in rows]))
    summary = {"auroc": _auroc(labels, scores), "auprc": _auprc(labels, scores)}
    return float(rows[best_idx]["threshold"]), rows, summary


def write_threshold_outputs(reliability_dir, best_threshold: float,
                            rows: Iterable[dict]) -> tuple[Path, Path]:
    out_dir = Path(reliability_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    best_path = out_dir / "reliability_threshold.txt"
    best_path.write_text(f"{best_threshold}\n")
    rows = list(rows)
    sweep_path = out_dir / "reliability_threshold_sweep.csv"
    if rows:
        with sweep_path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    else:
        sweep_path.write_text("")
    return best_path, sweep_path


def calibration_summary(
    scores: np.ndarray, labels: np.ndarray, n_bins: int = 10
) -> tuple[float, float, list[dict[str, float]]]:
    """(ECE, Brier, per-bin rows) for probability-like scores."""
    scores = np.asarray(scores, np.float32).reshape(-1)
    labels = np.asarray(labels, np.int32).reshape(-1)
    n = scores.shape[0]
    if n == 0:
        return float("nan"), float("nan"), []
    brier = float(np.mean((scores - labels) ** 2))
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    rows, ece = [], 0.0
    for i in range(n_bins):
        lo, hi = float(edges[i]), float(edges[i + 1])
        mask = (
            (scores >= lo) & (scores <= hi) if i == n_bins - 1
            else (scores >= lo) & (scores < hi)
        )
        count = int(mask.sum())
        center = (lo + hi) / 2
        if count == 0:
            rows.append({"bin_center": center, "mean_pred": float("nan"),
                         "empirical_id_rate": float("nan"), "count": 0})
            continue
        mean_pred = float(scores[mask].mean())
        empirical = float(labels[mask].mean())
        ece += (count / n) * abs(empirical - mean_pred)
        rows.append({"bin_center": center, "mean_pred": mean_pred,
                     "empirical_id_rate": empirical, "count": count})
    return float(ece), brier, rows


def write_calibration_outputs(reliability_dir, rows: Iterable[dict]) -> Path:
    out_dir = Path(reliability_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cal_path = out_dir / "reliability_calibration.csv"
    rows = list(rows)
    if rows:
        with cal_path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    else:
        cal_path.write_text("")
    return cal_path
