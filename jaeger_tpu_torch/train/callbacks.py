"""Copy of `jaeger_tpu/train/callbacks.py`.

Training callbacks: early stopping, LR plateau reduction, NaN guard,
CSV logging.

Parity targets: the Keras callbacks the reference configs name
(``train_config/*.yaml`` callbacks sections) and ``SyncTerminateOnNaN``
(reference ``nnlib/callbacks.py:16-57``). These operate on host-side
epoch metrics; their state is serialized by
:class:`jaeger_tpu.train.checkpoint.TrainingStatePersistence`, matching
the reference's ``TrainingStateCallback`` (``nnlib/builder.py:101-206``).
In multi-process training only the primary process writes the CSV log.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

from jaeger_tpu_torch.parallel.multihost import is_primary


def _resolve_mode(mode: str, monitor: str) -> str:
    """Keras ``mode="auto"`` resolution: maximize accuracy-like monitors,
    minimize everything else (``keras.callbacks.EarlyStopping`` /
    ``ReduceLROnPlateau`` monitor-op selection)."""
    if mode in ("min", "max"):
        return mode
    name = monitor.lower()
    if any(t in name for t in ("acc", "auc", "f1", "precision", "recall")):
        return "max"
    return "min"


class EarlyStopping:
    """``keras.callbacks.EarlyStopping`` semantics, pinned live in
    ``tests/test_callbacks_live_parity.py``: ``wait`` increments before
    the improvement check and only resets when the improvement also
    beats ``baseline``; stopping requires ``epoch > 0``; epochs before
    ``start_from_epoch`` are ignored entirely.  Defaults are Keras's
    (patience=0, restore_best_weights=False)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 0,
                 mode: str = "auto", restore_best_weights: bool = False,
                 min_delta: float = 0.0, baseline: float | None = None,
                 start_from_epoch: int = 0):
        self.monitor = monitor
        self.patience = patience
        self.mode = _resolve_mode(mode, monitor)
        self.restore_best_weights = restore_best_weights
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.start_from_epoch = start_from_epoch
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.best_params = None
        self.stopped = False

    def _improved(self, value: float, reference: float) -> bool:
        if self.mode == "min":
            return value < reference - self.min_delta
        return value > reference + self.min_delta

    def on_epoch_end(self, metrics: dict, params=None,
                     epoch: int = 0) -> bool:
        """Returns True when training should stop."""
        value = metrics.get(self.monitor)
        if value is None or epoch < self.start_from_epoch:
            return False
        value = float(value)

        def _snapshot(p):
            # the train step updates the parameters in place: keep a host
            # copy of the best ones
            if p is None:
                return None
            return {k: v.detach().to("cpu", copy=True) for k, v in p.items()}

        if self.restore_best_weights and self.best_params is None:
            self.best_params = _snapshot(params)
        self.wait += 1
        if self._improved(value, self.best):
            self.best = value
            if self.restore_best_weights and params is not None:
                self.best_params = _snapshot(params)
            if self.baseline is None or self._improved(value, self.baseline):
                self.wait = 0
            return False
        if self.wait >= self.patience and epoch > 0:
            self.stopped = True
        return self.stopped

    def state(self) -> dict:
        return {"best": self.best, "wait": self.wait}

    def restore(self, state: dict) -> None:
        self.best = state.get("best", self.best)
        self.wait = state.get("wait", self.wait)


class ReduceLROnPlateau:
    """``keras.callbacks.ReduceLROnPlateau`` semantics, pinned live:
    improvement must beat ``best`` by ``min_delta`` (Keras default
    1e-4); after a reduction the callback sits in ``cooldown`` epochs
    during which ``wait`` stays pinned to 0; no reduction happens once
    the LR is at or below ``min_lr``.  Defaults are Keras's
    (factor=0.1, patience=10, min_lr=0)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 10,
                 factor: float = 0.1, min_lr: float = 0.0,
                 mode: str = "auto", min_delta: float = 1e-4,
                 cooldown: int = 0):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support a "
                             f"factor >= 1.0 (got {factor})")
        self.monitor = monitor
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.mode = _resolve_mode(mode, monitor)
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, metrics: dict, current_lr: float | None,
                     epoch: int = 0):
        """Returns the new LR (or None to keep)."""
        value = metrics.get(self.monitor)
        if value is None or current_lr is None:
            return None
        value = float(value)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(value):
            self.best = value
            self.wait = 0
            return None
        if self.cooldown_counter > 0:
            return None
        self.wait += 1
        if self.wait >= self.patience:
            # Keras compares/sets the optimizer variable in float32
            old_lr = np.float32(current_lr)
            if old_lr > np.float32(self.min_lr):
                new_lr = max(float(old_lr * np.float32(self.factor)),
                             self.min_lr)
                self.cooldown_counter = self.cooldown
                self.wait = 0
                return new_lr
        return None

    def state(self) -> dict:
        return {"best": self.best, "wait": self.wait,
                "cooldown_counter": self.cooldown_counter}

    def restore(self, state: dict) -> None:
        self.best = state.get("best", self.best)
        self.wait = state.get("wait", self.wait)
        self.cooldown_counter = state.get(
            "cooldown_counter", self.cooldown_counter)


class TerminateOnNaN:
    """Stop when loss is non-finite (the host read of the loss is the
    sync point)."""

    def on_step(self, loss: float) -> bool:
        return not np.isfinite(loss)


class CSVLogger:
    def __init__(self, filename: str | Path, append: bool = True):
        self.path = Path(filename)
        self.append = append
        self._writer = None
        self._fh = None

    def on_epoch_end(self, epoch: int, metrics: dict) -> None:
        if not is_primary():
            return  # multi-process training: the log is the primary's
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            exists = self.path.exists() and self.append
            self._fh = self.path.open("a" if self.append else "w", newline="")
            self._writer = csv.DictWriter(self._fh, fieldnames=list(row))
            if not exists or self.path.stat().st_size == 0:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def build_callbacks(cfg_list: list[dict]) -> dict:
    """Instantiate callbacks from a config callbacks list (Keras names)."""
    out: dict = {}
    for entry in cfg_list or []:
        name = entry.get("name")
        params = entry.get("params") or {}
        if name == "EarlyStopping":
            out["early_stopping"] = EarlyStopping(
                monitor=params.get("monitor", "val_loss"),
                patience=params.get("patience", 0),
                mode=params.get("mode", "auto"),
                restore_best_weights=params.get(
                    "restore_best_weights", False),
                min_delta=params.get("min_delta", 0.0),
                baseline=params.get("baseline"),
                start_from_epoch=params.get("start_from_epoch", 0),
            )
        elif name == "ReduceLROnPlateau":
            out["reduce_lr"] = ReduceLROnPlateau(
                monitor=params.get("monitor", "val_loss"),
                patience=params.get("patience", 10),
                factor=params.get("factor", 0.1),
                min_lr=params.get("min_lr", 0.0),
                mode=params.get("mode", "auto"),
                min_delta=params.get("min_delta", 1e-4),
                cooldown=params.get("cooldown", 0),
            )
        elif name == "TerminateOnNaN":
            out["nan_guard"] = TerminateOnNaN()
        elif name == "CSVLogger":
            if params.get("filename"):
                out["csv_logger"] = CSVLogger(
                    params["filename"], append=params.get("append", True)
                )
        # ModelCheckpoint handled by the checkpoint manager
    return out
