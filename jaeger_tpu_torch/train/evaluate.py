"""Bundle evaluation on labeled datasets (CSV or converter NPZ).

Counterpart of `jaeger_tpu/train/evaluate.py`: batch a labeled set through
a saved bundle and report overall accuracy, macro F1, per-class
precision / recall / F1 and the confusion matrix. CSV rows go through the
port's ``InferenceEngine`` (device-side encode); NPZ frame tokens through
the model's ``tokens`` input in fixed batches.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.train import metrics as M


def _predict_tokens(model, feats: np.ndarray, batch_size: int,
                    device) -> np.ndarray:
    """Classifier logits over pre-encoded frame tokens, in fixed batches."""
    n = feats.shape[0]
    pad = (-n) % batch_size
    if pad:
        feats = np.concatenate([feats, np.zeros_like(feats[:pad])], axis=0)
    chunks = []
    with torch.inference_mode():
        for i in range(0, feats.shape[0], batch_size):
            tokens = torch.from_numpy(
                np.ascontiguousarray(feats[i:i + batch_size])).to(device)
            out = model(tokens=tokens.long(), heads=("prediction",))
            chunks.append(out["prediction"].float().cpu().numpy())
    return np.concatenate(chunks, axis=0)[:n]


def metrics_row(y_true: np.ndarray, logits: np.ndarray,
                num_classes: int) -> dict:
    """One flat metrics record (the sweep's CSV row)."""
    y_pred = np.argmax(logits, axis=1)
    row = {
        "n": int(y_true.shape[0]),
        "overall_accuracy": float((y_pred == y_true).mean()),
        "macro_f1": M.macro_f1_score(y_true, logits, num_classes),
    }
    for c in range(num_classes):
        row[f"precision_class_{c}"] = M.precision_for_class(y_true, logits, c)
        row[f"recall_class_{c}"] = M.recall_for_class(y_true, logits, c)
        row[f"f1_class_{c}"] = M.f1_for_class(y_true, logits, c)
    return row


def evaluate_bundle_on_npz(model_dir: str | Path, npz_path: str | Path,
                           batch_size: int = 512, key: str = "translated",
                           device=None):
    """Evaluate a saved bundle on a converter NPZ: ``(metrics_row,
    confusion_matrix, logits, y_true)``. Ragged object arrays are
    densified to the dataset's longest record."""
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.train.data import _densify, load_npz_dataset

    model, _, _ = load_model(model_dir, device=device)
    data = load_npz_dataset(npz_path, key)
    feats = data[key]
    if feats.dtype == object:
        feats = _densify(feats, np.arange(feats.shape[0]))
    y_true = np.asarray(data["labels"]).astype(np.int64).reshape(-1)
    logits = _predict_tokens(model, feats, batch_size,
                             next(model.parameters()).device)
    k = logits.shape[1]
    return (metrics_row(y_true, logits, k),
            M.confusion_matrix(y_true, logits, k), logits, y_true)


def evaluate_bundle_on_csv(model_dir: str | Path, csv_path: str | Path,
                           batch_size: int = 512, device=None):
    """Evaluate a saved bundle on a ``label,sequence`` CSV: ``(metrics_row,
    confusion_matrix, logits, y_true)``."""
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.seqops.windows import BASE_N, encode_ascii

    model, _, _ = load_model(model_dir, device=device)
    crop_nt = model.crop_nt
    rows = []
    with open(csv_path) as fh:
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) >= 2:
                try:
                    rows.append((int(parts[0]), parts[1]))
                except ValueError:
                    continue
    n = len(rows)
    bases = np.full((n, crop_nt), BASE_N, dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    y_true = np.zeros(n, dtype=np.int64)
    for i, (label, seq) in enumerate(rows):
        ids = encode_ascii(seq[:crop_nt])
        bases[i, : ids.shape[0]] = ids
        lengths[i] = ids.shape[0]
        y_true[i] = label
    engine = InferenceEngine(model, batch_size=batch_size,
                             device=next(model.parameters()).device,
                             output_keys=("prediction",))
    logits = np.asarray(engine.predict_windows(bases, lengths)["prediction"])
    k = logits.shape[1]
    return (metrics_row(y_true, logits, k),
            M.confusion_matrix(y_true, logits, k), logits, y_true)
