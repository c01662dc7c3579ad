"""Copy of `jaeger_tpu/train/metrics.py`.

Per-class evaluation metrics.

Parity target: reference ``nnlib/metrics.py`` — PrecisionForClass,
RecallForClass, SpecificityForClass, BinaryF1Score (logit threshold 0.0),
MacroF1Score. Functional (stateless) versions computed over full
prediction arrays; streaming accumulation is a host-side sum of the
returned count tuples.
"""

from __future__ import annotations

import numpy as np


def _counts(y_true: np.ndarray, y_pred: np.ndarray, class_id: int):
    tp = int(np.sum((y_pred == class_id) & (y_true == class_id)))
    fp = int(np.sum((y_pred == class_id) & (y_true != class_id)))
    fn = int(np.sum((y_pred != class_id) & (y_true == class_id)))
    tn = int(np.sum((y_pred != class_id) & (y_true != class_id)))
    return tp, fp, fn, tn


def _to_labels(y, logits_axis=-1):
    y = np.asarray(y)
    if y.ndim > 1 and y.shape[-1] > 1:
        return np.argmax(y, axis=logits_axis)
    return y.reshape(-1)


def precision_for_class(y_true, y_pred_logits, class_id: int) -> float:
    t, p = _to_labels(y_true), _to_labels(y_pred_logits)
    tp, fp, _, _ = _counts(t, p, class_id)
    return tp / (tp + fp) if (tp + fp) else 0.0


def recall_for_class(y_true, y_pred_logits, class_id: int) -> float:
    t, p = _to_labels(y_true), _to_labels(y_pred_logits)
    tp, _, fn, _ = _counts(t, p, class_id)
    return tp / (tp + fn) if (tp + fn) else 0.0


def specificity_for_class(y_true, y_pred_logits, class_id: int) -> float:
    t, p = _to_labels(y_true), _to_labels(y_pred_logits)
    _, fp, _, tn = _counts(t, p, class_id)
    return tn / (tn + fp) if (tn + fp) else 0.0


def f1_for_class(y_true, y_pred_logits, class_id: int) -> float:
    prec = precision_for_class(y_true, y_pred_logits, class_id)
    rec = recall_for_class(y_true, y_pred_logits, class_id)
    return 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0


def binary_f1_score(y_true, logits, threshold: float = 0.0) -> float:
    """F1 over a single-logit binary head thresholded at 0 (reference
    ``metrics.py:109-152``)."""
    y = np.asarray(y_true).reshape(-1)
    p = (np.asarray(logits).reshape(-1) > threshold).astype(int)
    tp = int(np.sum((p == 1) & (y == 1)))
    fp = int(np.sum((p == 1) & (y == 0)))
    fn = int(np.sum((p == 0) & (y == 1)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def macro_f1_score(y_true, y_pred_logits, num_classes: int) -> float:
    return float(np.mean([
        f1_for_class(y_true, y_pred_logits, c) for c in range(num_classes)
    ]))


def confusion_matrix(y_true, y_pred_logits, num_classes: int) -> np.ndarray:
    t, p = _to_labels(y_true), _to_labels(y_pred_logits)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (t.astype(int), p.astype(int)), 1)
    return cm


def classification_report(y_true, y_pred_logits, class_names: list[str]) -> str:
    lines = [f"{'class':<16}{'precision':>10}{'recall':>10}{'f1':>10}"]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:<16}"
            f"{precision_for_class(y_true, y_pred_logits, i):>10.3f}"
            f"{recall_for_class(y_true, y_pred_logits, i):>10.3f}"
            f"{f1_for_class(y_true, y_pred_logits, i):>10.3f}"
        )
    lines.append(
        f"{'macro-f1':<16}"
        f"{macro_f1_score(y_true, y_pred_logits, len(class_names)):>30.3f}"
    )
    return "\n".join(lines)
