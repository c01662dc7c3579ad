"""Checkpointing and resume (PyTorch files, JAX's JSON formats).

Counterpart of `jaeger_tpu/train/checkpoint.py`. ``CheckpointManager``
writes one torch file per epoch, ``<dir>/epoch_<NNN>.pt`` (the model's
state dict: parameters and batch statistics), and the optimizer state
beside it (``epoch_<NNN>_opt.pt``), and keeps the same ``checkpoints.json``
index (epoch, path, metrics, opt_path; the last ``keep`` epochs) from which
resume picks the latest or best entry. ``TrainingStatePersistence``
(``training_state.json``), the ``converged.json`` markers and
``resolve_resume_stage`` keep the JAX package's formats, so a run
directory has the same layout. In multi-process training only the primary
process writes any of them (``is_primary``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

import torch

from jaeger_tpu_torch.parallel.multihost import is_primary

logger = logging.getLogger("jaeger_tpu_torch")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_structure(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype
    return not isinstance(a, (dict, torch.Tensor)) and not isinstance(
        b, (dict, torch.Tensor))


def _to_devices_of(tree, template):
    """``tree`` with each tensor on the device of the template's tensor at
    its place (the optimizer state keeps its count and learning rate on
    the CPU and its moments beside the parameters)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(template.device)
    if isinstance(tree, dict):
        return {k: _to_devices_of(v, template[k]) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        if is_primary():
            self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._index_path = self.directory / "checkpoints.json"

    def _index(self) -> list[dict]:
        if self._index_path.exists():
            return json.loads(self._index_path.read_text())
        return []

    def _write_index(self, index: list[dict]) -> None:
        self._index_path.write_text(json.dumps(index, indent=1))

    def save(self, epoch: int, variables: dict[str, torch.Tensor],
             metrics: dict | None = None, opt_state: Any = None) -> Path:
        """``variables``: the model's state dict; ``opt_state`` (moments,
        accumulator, step) persists beside it so resume continues the
        optimizer where it stopped."""
        path = (self.directory / f"epoch_{epoch:03d}.pt").resolve()
        if not is_primary():
            # multi-process training: the files are the primary's
            return path
        torch.save(_to_cpu(variables), path)
        entry = {
            "epoch": epoch,
            "path": str(path),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        if opt_state is not None:
            opt_path = (self.directory / f"epoch_{epoch:03d}_opt.pt").resolve()
            torch.save(_to_cpu(opt_state), opt_path)
            entry["opt_path"] = str(opt_path)
        index = [e for e in self._index() if e["epoch"] != epoch]
        index.append(entry)
        index.sort(key=lambda e: e["epoch"])
        while len(index) > self.keep:
            old = index.pop(0)
            for p in (old.get("path"), old.get("opt_path")):
                if p and Path(p).exists():
                    Path(p).unlink()
        self._write_index(index)
        return path

    def latest(self) -> dict | None:
        index = self._index()
        return index[-1] if index else None

    def best(self, monitor: str = "val_loss", mode: str = "min") -> dict | None:
        index = [e for e in self._index() if monitor in e.get("metrics", {})]
        if not index:
            return self.latest()
        key = lambda e: e["metrics"][monitor]  # noqa: E731
        return min(index, key=key) if mode == "min" else max(index, key=key)

    def restore(self, entry: dict) -> dict[str, torch.Tensor]:
        return torch.load(Path(entry["path"]), map_location="cpu",
                          weights_only=True)

    def restore_opt_state(self, entry: dict, template: Any) -> Any:
        """The optimizer state saved with this entry, each tensor on the
        device of its counterpart in the template, or the (fresh) template
        when there is none or it does not match the current optimizer
        configuration (weights-only resume)."""
        opt_path = entry.get("opt_path")
        if not opt_path or not Path(opt_path).exists():
            return template
        state = torch.load(Path(opt_path), map_location="cpu",
                           weights_only=True)
        if not _same_structure(state, template):
            logger.warning(
                "saved optimizer state at %s does not match the current "
                "optimizer configuration; resuming with fresh optimizer "
                "state (weights-only resume)", opt_path)
            return template
        return _to_devices_of(state, template)


class TrainingStatePersistence:
    """training_state.json: epoch counter + callback states + LR."""

    def __init__(self, directory: str | Path):
        self.path = Path(directory) / "training_state.json"

    def save(self, epoch: int, lr: float | None, callbacks: dict) -> None:
        if not is_primary():
            return
        state = {"epoch": epoch, "learning_rate": lr}
        for name in ("early_stopping", "reduce_lr"):
            if name in callbacks:
                state[name] = callbacks[name].state()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(state, indent=1))

    def load(self) -> dict | None:
        if self.path.exists():
            return json.loads(self.path.read_text())
        return None

    def restore_into(self, callbacks: dict) -> dict | None:
        state = self.load()
        if state is None:
            return None
        for name in ("early_stopping", "reduce_lr"):
            if name in callbacks and name in state:
                callbacks[name].restore(state[name])
        return state


def write_convergence_marker(directory: str | Path, branch: str,
                             info: dict) -> None:
    if not is_primary():
        return
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "converged.json").write_text(
        json.dumps({"branch": branch, **info}))


def read_convergence_marker(directory: str | Path) -> dict | None:
    marker = Path(directory) / "converged.json"
    if marker.exists():
        return json.loads(marker.read_text())
    return None


def resolve_resume_stage(checkpoint_root: Path) -> tuple[str | None, dict | None]:
    """Most advanced stage with a checkpoint wins: reliability > classifier
    > projection."""
    for stage in ("reliability", "classifier", "projection"):
        mgr_dir = Path(checkpoint_root) / stage
        if (mgr_dir / "checkpoints.json").exists():
            entry = CheckpointManager(mgr_dir).latest()
            if entry:
                return stage, entry
    return None, None
