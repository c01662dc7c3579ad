"""The training step and the per-batch program dispatch (PyTorch).

Counterpart of `jaeger_tpu/train/loop.py`: the step runs the
model's training forward (batch statistics, dropout, the fused convs on
``FusedConvBlockFn``), the branch loss plus the regularization penalty,
autograd for the gradients, zeroes the frozen parameters' gradients and
applies the optimizer in place (``Optimizer.apply``: Adam and AdamW on the
card as one kernel pair over all leaves). The dispatching step picks the
dense, bounded or masked program per host batch with the port's
``dense_window_batch`` and ``bounded_mask_levels``, as the JAX step does:
the bounded program is bitwise the masked forward on batches that qualify,
so the same function's gradients.

Under a ``torch.distributed`` process group (multi-process training,
:mod:`jaeger_tpu_torch.parallel.multihost`) each process runs the step on
its rows of the global batch: the batch statistics are the global
batch's (the layers all-reduce them), and the step all-reduces the
gradients with the loss and accuracy in one flat buffer and divides by
the world size, so every process applies the same update and reports
the global metrics.

Spans (:mod:`jaeger_tpu_torch.utils.spans`): a step's ``train/forward``
(the model, the loss and the regularizer), ``train/backward`` (autograd
and the gradient dict) and ``train/optimizer`` (the update in place and
the gradient norm).

Frozen parameters (``StepConfig.frozen_prefixes``, matched against flax
paths) get zero gradients as ``_mask_frozen`` gives them; the port does not
ask autograd for them at all (they are set not to require gradients for
the step), which gives the same gradients for the others. AdamW still
decays them, as optax does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from jaeger_tpu_torch.models.builder import mask_cut_plan
from jaeger_tpu_torch.ops.encode import bounded_mask_levels, dense_window_batch
from jaeger_tpu_torch.parallel import multihost as mh
from jaeger_tpu_torch.train import losses as losses_lib
from jaeger_tpu_torch.train.optimizers import Optimizer
from jaeger_tpu_torch.utils.spans import span


@dataclass
class StepConfig:
    loss_name: str = "categorical_crossentropy"
    loss_params: dict | None = None
    output_key: str = "prediction"
    class_weights: torch.Tensor | None = None
    reg_specs: tuple = ()
    frozen_prefixes: tuple = ()
    # output heads this branch computes (None = all): a classifier step
    # must not run the NMD taps or update their moving means
    heads: tuple | None = None
    # maskless program: exact only when every window fills the crop with
    # unambiguous bases
    assume_dense: bool = False
    # bounded-mask cut spec (builder.mask_cut_plan)
    mask_layers: object = None


def flax_params(model: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    """The model's parameters keyed by flax path (``/``-joined)."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


@dataclass
class TrainState:
    """The model (its parameters and batch statistics), the optimizer, its
    state and the last step's gradients (flax paths)."""

    model: torch.nn.Module
    tx: Optimizer
    opt_state: dict
    grads: dict | None = None

    @classmethod
    def create(cls, model, tx: Optimizer) -> "TrainState":
        params = {k: p.detach() for k, p in flax_params(model).items()}
        return cls(model=model, tx=tx, opt_state=tx.init(params))

    @property
    def params(self) -> dict[str, torch.nn.Parameter]:
        return flax_params(self.model)

    @property
    def variables(self) -> dict[str, torch.Tensor]:
        """The state dict: parameters and batch statistics."""
        return self.model.state_dict()


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """A host batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _loss_base(cfg: StepConfig):
    loss_params = dict(cfg.loss_params or {})
    loss_params.pop("from_logits", None)
    if cfg.loss_name in ("hierachical_loss", "hierarchical_loss"):
        parent_of = tuple(loss_params.pop("parent_of"))
        groups = tuple(tuple(g) for g in loss_params.pop("groups"))

        def base(labels, logits, class_weights=None, **kw):
            return losses_lib.hierarchical_loss(labels, logits, parent_of,
                                                groups, **kw)
        return base, loss_params
    return losses_lib.LOSSES[cfg.loss_name], loss_params


def model_inputs(batch: dict[str, torch.Tensor]) -> dict:
    """The model's keyword inputs from a device batch."""
    kw = {}
    if "bases" in batch:
        kw.update(bases=batch["bases"], lengths=batch["lengths"])
    else:
        kw["tokens"] = batch["translated"]
    if "frame_perm" in batch:
        kw["frame_perm"] = batch["frame_perm"]
    return kw


def make_train_step(model, cfg: StepConfig) -> Callable:
    """``(state, batch, generator) -> (state, metrics)``; ``batch`` holds
    tensors on the model's device (``bases``/``lengths`` or
    ``translated``, optional ``frame_perm``, and ``labels``). The state's
    parameters and batch statistics are updated in place; the metrics are
    device scalars."""
    loss_base, loss_params = _loss_base(cfg)

    def train_step(state: TrainState, batch, generator=None):
        with span("train/forward"):
            params = state.params
            frozen = {k for k in params
                      if any(k.startswith(p) for p in cfg.frozen_prefixes)}
            for k, p in params.items():
                p.requires_grad_(k not in frozen)
            out = model(**model_inputs(batch), train=True, heads=cfg.heads,
                        assume_dense=cfg.assume_dense,
                        mask_layers=None if cfg.assume_dense else cfg.mask_layers,
                        generator=generator)
            logits = out[cfg.output_key]
            labels = batch["labels"]
            loss = loss_base(labels, logits, class_weights=cfg.class_weights,
                             **loss_params)
            reg = losses_lib.regularization_loss(params, list(cfg.reg_specs))
            total = loss + reg
        with span("train/backward"):
            live = [k for k in params if k not in frozen]
            got = torch.autograd.grad(total, [params[k] for k in live],
                                      allow_unused=True)
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            for k, g in zip(live, got):
                if g is not None:
                    grads[k] = g.float()
            for p in params.values():
                p.requires_grad_(False)
        accuracy = None
        if labels.dim() == 2 and logits.shape == labels.shape:
            accuracy = torch.mean(
                (torch.argmax(logits, -1) == torch.argmax(labels, -1)).float())
        loss = loss.detach()
        if mh.is_distributed():
            # data parallel: every process holds an equal share of the
            # global batch and each loss is a mean over its rows, so the
            # global gradient, loss and accuracy are the means over the
            # processes (one all-reduce of one flat buffer)
            extra = {("metric", "loss"): loss}
            if accuracy is not None:
                extra[("metric", "accuracy")] = accuracy
            reduced = mh.all_reduce_mean({**grads, **extra})
            loss = reduced.pop(("metric", "loss"))
            accuracy = reduced.pop(("metric", "accuracy"), None)
            grads = reduced
            total = loss + reg
        with span("train/optimizer"):
            state.opt_state, grad_norm = state.tx.apply(
                params, grads, state.opt_state)
        state.grads = grads
        metrics = {"loss": loss,
                   "reg_loss": torch.as_tensor(reg).detach(),
                   "total_loss": total.detach(),
                   "grad_norm": grad_norm}
        if accuracy is not None:
            metrics["accuracy"] = accuracy
        return state, metrics

    return train_step


def shard_train_step(train_step: Callable, batcher, device) -> Callable:
    """``(state, host_batch, generator) -> (state, metrics)``: the step on
    the host batch uploaded to ``device``; with a ``batcher``
    (:class:`~jaeger_tpu_torch.parallel.multihost.GlobalBatcher`) on this
    process's rows of the global batch only, the counterpart of JAX's jit
    with the batch sharded over the data axis (the step all-reduces the
    gradients and statistics)."""
    def step(state, batch, generator=None):
        if batcher is not None:
            batch = batcher.shard(batch)
        return train_step(state, to_device(batch, device), generator)
    return step


def make_dispatching_train_step(model, cfg: StepConfig, device,
                                global_batcher=None) -> Callable:
    """``(state, host_batch, generator) -> (state, metrics)`` choosing the
    dense, bounded or masked program per host batch (numpy, before
    upload), as ``jaeger_tpu/train/loop.py:175-265``. Batches without raw
    ``bases`` always take the masked program. ``program_counts`` on the
    returned function counts the steps by program. The step does not wait
    for the card; the upload of the next batch waits for the step before
    it, after the next batch's program is chosen on the host.

    ``global_batcher`` (multi-process training): the program is chosen on
    the full global host batch, so every process takes the same program
    and issues the same collectives; the step then runs on this process's
    rows (:func:`shard_train_step`). A model built with
    ``parallel.seq_axis`` length-shards its Hyena blocks over the ambient
    mesh (``parallel.mesh.use_mesh``), differentiably."""
    crop_nt = getattr(model, "crop_nt", None)
    masking = getattr(model, "masking_enabled", True)
    mask_plans = mask_cut_plan(
        (getattr(model, "config", None) or {}).get(
            "representation_learner", {})) or []
    steps: dict = {}
    counts: dict = {}

    def step_fn(state, batch, generator=None):
        dense = False
        mask_cut = None
        if crop_nt is not None and "bases" in batch and "lengths" in batch:
            b = np.asarray(batch["bases"])
            ln = np.asarray(batch["lengths"])
            dense = dense_window_batch(b, ln, crop_nt, masking)
            if not dense and mask_plans:
                levels = bounded_mask_levels(b, ln, crop_nt, masking,
                                             mask_plans)
                if levels.size and (levels >= 0).all():
                    mask_cut = mask_plans[int(levels.max())][0]
        key = "dense" if dense else ("masked" if mask_cut is None
                                     else ("bounded", mask_cut))
        fn = steps.get(key)
        if fn is None:
            fn = steps[key] = shard_train_step(make_train_step(model, replace(
                cfg, assume_dense=dense, mask_layers=mask_cut)),
                global_batcher, device)
        name = key if isinstance(key, str) else "bounded"
        counts[name] = counts.get(name, 0) + 1
        return fn(state, batch, generator)

    step_fn.program_counts = counts
    return step_fn
