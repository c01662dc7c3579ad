"""Training steps of the classifier head, in plain PyTorch float32.

The loss is Keras' categorical cross-entropy from logits with label
smoothing ``s`` (targets ``y (1 - s) + s / classes``), averaged over the
batch, plus no regularization (the configurations state none). Each
parameter's gradient is clipped to norm ``clipnorm`` on its own (Keras'
``clipnorm``), then Keras 3's AdamW moves it: ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g^2``, ``u = sqrt(1 - b2^t) / (1 - b1^t) m /
(sqrt(v) + eps) + wd p``, ``p -= lr u``. Every parameter is decayed, the
statistics (moving means and variances) are not parameters and stay.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import Reference
from benchmark.reference.windows import six_frames

STATISTICS = ("moving_mean", "moving_variance")


def is_parameter(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in STATISTICS


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, smoothing: float):
    k = labels.shape[-1]
    target = labels * (1.0 - smoothing) + smoothing / k
    return -(target * F.log_softmax(logits, -1)).sum(-1).mean()


def train_steps(model_cfg: dict, train_cfg: dict, params: dict,
                batches: list[dict], device, seed: int,
                rounding: str = "float32") -> dict:
    """Run ``len(batches)`` steps from ``params`` (not changed) on the host
    batches (``bases``, ``lengths``, one-hot ``labels``), the dropout
    masks drawn from a generator on ``device`` seeded with ``seed``, the
    model's products and activations rounded as ``rounding`` says
    (:class:`~benchmark.reference.model.Reference`).
    Returns each step's loss, the first step's clipped gradients and the
    parameters after the last step."""
    opt = dict(train_cfg.get("optimizer_params", {}))
    if str(train_cfg.get("optimizer", "adam")).lower() not in ("adam", "adamw"):
        raise ValueError("the reference knows Adam and AdamW")
    lr = float(opt.get("learning_rate", 1e-3))
    wd = (float(opt.get("weight_decay", 0.004))
          if str(train_cfg["optimizer"]).lower() == "adamw" else 0.0)
    b1, b2 = float(opt.get("beta_1", 0.9)), float(opt.get("beta_2", 0.999))
    eps = float(opt.get("epsilon", 1e-7))
    clip = opt.get("clipnorm")
    smoothing = float((train_cfg.get("loss_params_classifier") or {})
                      .get("label_smoothing", 0.0))
    if train_cfg.get("loss_classifier", "categorical_crossentropy") != \
            "categorical_crossentropy":
        raise ValueError("the reference knows categorical cross-entropy")

    p = {k: v.detach().to(device, torch.float32).clone() for k, v in params.items()}
    names = [k for k in p if is_parameter(k)]
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses, first_grads = [], None
    generator = torch.Generator(device=device).manual_seed(int(seed))
    crop = 3 * int(model_cfg["string_processor"]["crop_size"]) + 5
    for t, batch in enumerate(batches, start=1):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        ref = Reference(model_cfg, {**p, **leaves}, rounding=rounding,
                        generator=generator)
        tokens = six_frames(torch.from_numpy(batch["bases"]).to(device),
                            torch.from_numpy(batch["lengths"]).to(device), crop)
        logits = ref.forward(tokens, train=True, heads=("prediction",))["prediction"]
        loss = loss_fn(logits, torch.from_numpy(batch["labels"]).to(device).float(),
                       smoothing)
        got = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {}
            for k, g in zip(names, got):
                g = torch.zeros_like(p[k]) if g is None else g
                if clip:
                    g = g * (float(clip) / torch.clamp_min(g.norm(), float(clip)))
                grads[k] = g
            if t == 1:
                first_grads = {k: g.clone() for k, g in grads.items()}
            alpha = (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
            for k in names:
                m[k] = b1 * m[k] + (1 - b1) * grads[k]
                v[k] = b2 * v[k] + (1 - b2) * grads[k] ** 2
                u = alpha * m[k] / (torch.sqrt(v[k]) + eps) + wd * p[k]
                p[k] = (p[k] - lr * u).detach()
    return {"losses": losses, "first_grads": first_grads, "params": p}
