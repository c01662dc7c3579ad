"""Losses of the classifier and reliability branches (PyTorch).

Counterpart of `jaeger_tpu/train/losses.py`: categorical and sparse
categorical cross-entropy (label smoothing, class weights), binary
cross-entropy, ``mse``, the hierarchical fine + coarse loss and the
config-driven regularization penalty. Every reduction is the mean over the
batch, like Keras' ``SUM_OVER_BATCH_SIZE``. ArcFace, npairs and supervised
contrastive losses serve the self-supervised projection pretraining and
are not ported yet (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F


def categorical_crossentropy(labels_onehot, logits, from_logits=True,
                             class_weights=None, label_smoothing=0.0):
    labels_onehot = labels_onehot.float()
    if label_smoothing:
        # Keras CategoricalCrossentropy(label_smoothing=s): y*(1-s) + s/k
        k = labels_onehot.shape[-1]
        labels_onehot = (labels_onehot * (1.0 - label_smoothing)
                         + label_smoothing / k)
    if from_logits:
        logp = F.log_softmax(logits.float(), dim=-1)
    else:
        logp = torch.log(torch.clamp(logits.float(), 1e-7, 1.0))
    per_ex = -torch.sum(labels_onehot * logp, dim=-1)
    if class_weights is not None:
        w = torch.sum(labels_onehot * class_weights[None, :], dim=-1)
        per_ex = per_ex * w
    return torch.mean(per_ex)


def sparse_categorical_crossentropy(labels, logits, from_logits=True,
                                    class_weights=None):
    onehot = F.one_hot(labels.long().reshape(-1), logits.shape[-1]).float()
    return categorical_crossentropy(onehot, logits, from_logits,
                                    class_weights)


def binary_crossentropy(labels, logits, from_logits=True, class_weights=None):
    logits = logits.float()
    labels = labels.float().reshape(logits.shape)
    if from_logits:
        per_ex = (torch.clamp_min(logits, 0) - logits * labels
                  + torch.log1p(torch.exp(-torch.abs(logits))))
    else:
        p = torch.clamp(logits, 1e-7, 1 - 1e-7)
        per_ex = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    per_ex = torch.mean(per_ex, dim=-1)
    if class_weights is not None:
        w = torch.where(labels.reshape(per_ex.shape) > 0.5,
                        class_weights[1], class_weights[0])
        per_ex = per_ex * w
    return torch.mean(per_ex)


def mse(labels, preds, **_):
    return torch.mean(torch.square(labels.float() - preds.float()))


def hierarchical_loss(y_true, fine_logits, parent_of, groups,
                      l_fine: float = 1.0, l_coarse: float = 1.5,
                      class_weights=None):
    """Fine CE plus coarse CE over logsumexp-grouped logits."""
    del class_weights  # the JAX loss ignores them too
    fine_logits = fine_logits.float()
    if y_true.dim() == 2:
        y_true = torch.argmax(y_true, dim=-1)
    y_true = y_true.reshape(-1).long()
    logp_fine = F.log_softmax(fine_logits, dim=-1)
    loss_fine = -torch.gather(logp_fine, 1, y_true[:, None])[:, 0]
    coarse_logits = torch.stack(
        [torch.logsumexp(fine_logits[:, list(g)], dim=1) for g in groups],
        dim=1)
    parent = torch.as_tensor(parent_of, device=y_true.device)
    y_coarse = parent[y_true]
    logp_coarse = F.log_softmax(coarse_logits, dim=-1)
    loss_coarse = -torch.gather(logp_coarse, 1, y_coarse[:, None])[:, 0]
    return torch.mean(l_fine * loss_fine + l_coarse * loss_coarse)


def regularization_loss(params: dict[str, torch.Tensor],
                        specs: list[tuple[str, str, float]]):
    """Sum of the (path regex, l1 | l2, weight) penalties over ``params``,
    keyed by flax paths (``/``-joined)."""
    total = 0.0
    for path, leaf in params.items():
        for pattern, kind, weight in specs:
            if re.search(pattern, path):
                if kind == "l2":
                    total = total + weight * torch.sum(torch.square(leaf))
                elif kind == "l1":
                    total = total + weight * torch.sum(torch.abs(leaf))
    return total


LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mse,
}
