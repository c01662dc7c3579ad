"""Labelled training fragments, as ``train`` reads them, from the seed.

``rows`` lines of ``label,sequence``: the labels are the classes in turn,
shuffled; a row of class ``c`` has GC content ``gc_base + gc_step * c``
and ``crop + extra`` bases. No row holds an N (training CSVs are filtered
by N content), so every batch takes the dense program. Every seed gets the
same labels and lengths; the bases differ. The class mix follows
``chip_smoke.py``'s ``write_train_data``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def make(params: dict, seed: int, workdir: Path, crop_nt: int,
         classes: int) -> dict:
    """Write ``train.csv`` under ``workdir``; returns its ``path``."""
    if classes > 10:
        raise ValueError("labels are written as one digit")
    rng = np.random.default_rng(seed)
    rows = int(params["rows"])
    length = crop_nt + int(params["extra"])
    labels = rng.permutation(np.arange(rows) % classes)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = np.empty((rows, length + 3), np.uint8)
    for c in range(classes):
        idx = np.nonzero(labels == c)[0]
        gc = float(params["gc_base"]) + float(params["gc_step"]) * c
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        out[idx, 2:-1] = acgt[rng.choice(4, size=(idx.size, length), p=p)]
    out[:, 0] = ord("0") + labels
    out[:, 1] = ord(",")
    out[:, -1] = ord("\n")
    path = Path(workdir) / "train.csv"
    path.write_bytes(out.tobytes())
    return {"path": str(path)}
