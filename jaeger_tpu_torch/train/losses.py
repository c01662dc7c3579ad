"""Losses of the projection, classifier and reliability branches (PyTorch).

Counterpart of `jaeger_tpu/train/losses.py`: categorical and sparse
categorical cross-entropy (label smoothing, class weights), binary
cross-entropy, ``mse``, the hierarchical fine + coarse loss, the
config-driven regularization penalty, and the self-supervised projection
pretraining's losses: ``ArcFaceLoss`` (trainable class centroids),
``npairs_loss`` and ``supervised_contrastive_loss``. Every reduction is
the mean over the batch, like Keras' ``SUM_OVER_BATCH_SIZE``.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F
from torch import nn


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


def npairs_loss(y_true, y_pred):
    """Cross-entropy of ``y_pred`` rows against the uniform distribution
    over the rows that share the row's label."""
    y_true = y_true.to(y_pred.dtype)[:, None]
    same = (y_true == y_true.T).to(y_pred.dtype)
    same = same / torch.sum(same, dim=1, keepdim=True)
    logp = F.log_softmax(y_pred, dim=-1)
    return torch.mean(-torch.sum(same * logp, dim=-1))


def supervised_contrastive_loss(labels, features, temperature: float = 1.0):
    """``npairs_loss`` over the cosine similarities of ``features``
    (l2-normalized with a 1e-12 floor on the norm) over ``temperature``;
    one-hot ``labels`` are reduced to their argmax."""
    if labels.dim() > 1:
        labels = torch.argmax(labels, dim=-1)
    feats = features / torch.clamp_min(
        torch.linalg.norm(features, dim=1, keepdim=True), 1e-12)
    logits = (feats @ feats.T) / temperature
    return npairs_loss(labels, logits)


class ArcFaceLoss(nn.Module):
    """ArcFace with trainable class centroids, in f32 whatever the
    embeddings' dtype: embeddings and ``class_weights`` (num_classes,
    embedding_dim) l2-normalized with eps 1e-4 on the squared norm, the
    additive angular margin ``cos(arccos(cos) + margin)`` on the target
    class, then the cross-entropy of the ``scale``-d logits. The cosine is
    clipped to ``+-(1 - 1e-9)`` as JAX's is, which is +-1 in f32.
    ``class_weights`` start glorot-uniform from ``generator``."""

    def __init__(self, num_classes: int, embedding_dim: int,
                 margin: float = 0.5, scale: float = 30.0,
                 onehot: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = int(num_classes)
        self.margin = float(margin)
        self.scale = float(scale)
        self.onehot = bool(onehot)
        lim = math.sqrt(6.0 / (num_classes + embedding_dim))
        self.class_weights = nn.Parameter(
            (torch.rand((num_classes, embedding_dim), generator=generator)
             * 2 - 1) * lim)

    def forward(self, labels, embeddings):
        def l2n(x, eps=1e-4):
            return x / torch.sqrt(torch.clamp_min(
                torch.sum(torch.square(x), dim=1, keepdim=True), eps))

        emb = l2n(embeddings.float())
        wn = l2n(self.class_weights.float())
        cosine = emb @ wn.T
        if self.onehot:
            onehot = labels.float()
        else:
            onehot = F.one_hot(labels.reshape(-1).long(),
                               self.num_classes).float()
        eps = 1e-9
        theta = torch.arccos(torch.clamp(cosine, -1.0 + eps, 1.0 - eps))
        target = torch.cos(theta + self.margin)
        logits = (cosine * (1 - onehot) + target * onehot) * self.scale
        logp = F.log_softmax(logits, dim=-1)
        return torch.mean(-torch.sum(onehot * logp, dim=-1))


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
