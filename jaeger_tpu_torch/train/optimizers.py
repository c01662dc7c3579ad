"""Optimizers with the JAX package's update rules, written on tensors.

Counterpart of `jaeger_tpu/train/optimizers.py` (``make_optimizer``, an
optax chain there): Keras-3 Adam / AdamW (epsilon added to the
uncorrected ``sqrt(v)``), Keras Muon, SGD with Keras' velocity (the
learning rate folded into the gradient before the momentum trace), RMSprop
with epsilon inside the square root, Adagrad; per-variable ``clipnorm``,
``global_clipnorm``, the cosine schedule with warmup and gradient
accumulation (optax ``MultiSteps``: the running mean of the gradients, an
update every k-th step). This is the port's own update code, not
``torch.optim``, whose rules differ.

State is a dict of tensors (saved with the checkpoint). Parameters,
gradients and moments are dicts keyed by flax paths (``/``-joined, e.g.
``rep/masked_conv1d_0/kernel``); sums over leaves (the global norm) run in
flax's leaf order. Arithmetic is f32 with each constant as optax holds it:
``inject_hyperparams`` turns a constant learning rate and every numeric
argument of ``rmsprop`` / ``adagrad`` into f32 arrays, so ``1 - decay`` is
computed in f32 there, while Adam's betas stay Python floats.

AdamW decays every parameter, frozen ones included, as the JAX chain
(``optax.add_decayed_weights`` after ``_mask_frozen``) does.

:meth:`Optimizer.apply` takes a step in place. Adam and AdamW without
accumulation or ``global_clipnorm`` on CUDA f32 parameters run it as one
kernel pair over all leaves (:mod:`jaeger_tpu_torch.ops.fused_adamw`,
``mu`` and ``nu`` updated in place); every other optimizer, setting and
device runs :meth:`Optimizer.update` leaf by leaf, the kernel's plain
version.
"""

from __future__ import annotations

import math
import re

import torch

from jaeger_tpu_torch.utils import spans

F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


def _dev(v, like: torch.Tensor):
    return v.to(like.device) if isinstance(v, torch.Tensor) else v


def flax_order(keys) -> list[str]:
    """Keys in the order ``jax.tree.leaves`` visits a flax dict."""
    return sorted(keys, key=lambda k: tuple(k.split("/")))


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares, leaves summed in
    flax order."""
    total = None
    for k in flax_order(tree):
        s = torch.sum(torch.square(tree[k]))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _adam_alpha(count: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """Keras' bias correction ``sqrt(1 - b2^t) / (1 - b1^t)`` at step
    ``count`` (a CPU tensor), in f32 on the CPU."""
    t = count.to(F32)
    return torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)


def make_schedule(params: dict):
    """A float (constant rate) or ``f(count) -> f32 tensor``: cosine decay
    with optional linear warmup (``optax.cosine_decay_schedule`` joined to
    ``optax.linear_schedule``)."""
    lr = params.get("learning_rate", 1e-3)
    if not (isinstance(lr, dict) or params.get("lr_schedule") == "cosine"):
        return float(lr)
    sched_cfg = lr if isinstance(lr, dict) else params
    init = float(sched_cfg.get("initial_learning_rate",
                               sched_cfg.get("learning_rate", 1e-3)))
    decay_steps = int(sched_cfg.get("decay_steps", 10000))
    alpha = float(sched_cfg.get("alpha", 0.0))
    warmup = int(sched_cfg.get("warmup_steps", 0))

    def cosine(count):
        c = torch.clamp(_f32(count), max=float(decay_steps))
        decay = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    def schedule(count):
        if warmup and count < warmup:
            frac = 1 - torch.clamp(_f32(count), 0, warmup) / warmup
            return (0.0 - init) * frac + init
        return cosine(count - warmup if warmup else count)

    return schedule


def _newton_schulz5(x, steps: int, a: float, b: float, c: float):
    """Quintic Newton-Schulz orthogonalization (Keras Muon)."""
    transpose = x.shape[0] > x.shape[1]
    if transpose:
        x = x.T
    x = x / (torch.linalg.norm(x) + 1e-7)
    for _ in range(steps):
        ta = x @ x.T
        tb = b * ta + c * (ta @ ta)
        x = a * x + tb @ x
    return x.T if transpose else x


class Optimizer:
    """``make_optimizer``'s chain: clip per variable, clip globally, the
    named update, then accumulation. ``init(params)`` -> state;
    ``update(grads, state, params)`` -> (updates to add, new state);
    ``apply(params, grads, state)`` -> (new state, gradient norm), the
    step taken in place."""

    def __init__(self, name: str = "adam", params: dict | None = None,
                 accumulation_steps: int = 1):
        params = dict(params or {})
        self.clipnorm = params.pop("clipnorm", None)
        self.global_clipnorm = params.pop("global_clipnorm", None)
        self.weight_decay = float(params.pop("weight_decay", 0.004))
        self.lr = make_schedule(params)
        self.name = (name or "adam").lower()
        if self.name not in ("adam", "adamw", "muon", "sgd", "rmsprop",
                             "adagrad"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.hp = params
        self.k = int(accumulation_steps or 1)

    # -- state ---------------------------------------------------------------

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        state: dict = {"count": torch.zeros((), dtype=torch.int64)}
        if not callable(self.lr):
            state["learning_rate"] = _f32(self.lr)
        hp = self.hp
        if self.name in ("adam", "adamw", "muon"):
            state["mu"] = dict(zeros)
            state["nu"] = {k: torch.zeros_like(v) for k, v in params.items()}
        elif self.name == "sgd":
            state["trace"] = dict(zeros)
        elif self.name == "rmsprop":
            state["nu"] = dict(zeros)
            if hp.get("centered", False):
                state["mu"] = {k: torch.zeros_like(v)
                               for k, v in params.items()}
            if hp.get("momentum"):
                state["trace"] = {k: torch.zeros_like(v)
                                  for k, v in params.items()}
        elif self.name == "adagrad":
            acc = float(_f32(hp.get("initial_accumulator_value", 0.1)))
            state["sum_of_squares"] = {
                k: torch.full_like(v, acc) for k, v in params.items()}
        if self.k > 1:
            state["mini_step"] = torch.zeros((), dtype=torch.int64)
            state["acc_grads"] = {k: torch.zeros_like(v)
                                  for k, v in params.items()}
        return state

    def _hp(self, name: str, default):
        """A numeric argument as optax holds it: an f32 array when
        ``inject_hyperparams`` injected it (constant learning rate), else
        the Python float."""
        v = self.hp.get(name, default)
        return float(v) if callable(self.lr) else _f32(v)

    def _rate(self, state) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(int(state["count"]))
        return state["learning_rate"]

    # -- the update ------------------------------------------------------------

    def _clip(self, grads):
        if self.clipnorm:
            m = float(self.clipnorm)
            grads = {k: g * (m / torch.clamp_min(
                torch.sqrt(torch.sum(torch.square(g))), m))
                for k, g in grads.items()}
        if self.global_clipnorm:
            m = float(self.global_clipnorm)
            n = global_norm(grads)
            if not bool(n < m):
                grads = {k: (g / n) * m for k, g in grads.items()}
        return grads

    def _inner(self, grads, state, params):
        """The named optimizer's updates and its new state."""
        hp = self.hp
        lr = self._rate(state).to(next(iter(grads.values())).device)
        count = state["count"] + 1
        new = dict(state, count=count)
        if self.name in ("adam", "adamw"):
            b1 = hp.get("beta_1", 0.9)
            b2 = hp.get("beta_2", 0.999)
            eps = hp.get("epsilon", 1e-7)
            wd = self.weight_decay if self.name == "adamw" else 0.0
            alpha = _adam_alpha(count, b1, b2)
            mu, nu, out = {}, {}, {}
            for k, g in grads.items():
                mu[k] = b1 * state["mu"][k] + (1.0 - b1) * g
                nu[k] = b2 * state["nu"][k] + (1.0 - b2) * torch.square(g)
                u = alpha.to(g.device) * mu[k] / (torch.sqrt(nu[k]) + eps)
                if wd:
                    u = u + wd * params[k]
                out[k] = u * (-lr)
            new.update(mu=mu, nu=nu)
            return out, new
        if self.name == "muon":
            return self._muon(grads, state, params, lr, new)
        if self.name == "sgd":
            mom = hp.get("momentum") or 0.0
            nest = hp.get("nesterov", False)
            trace, out = {}, {}
            for k, g in grads.items():
                g = g * (-lr)
                trace[k] = g + mom * state["trace"][k]
                out[k] = g + mom * trace[k] if nest else trace[k]
            new["trace"] = trace
            return out, new
        if self.name == "rmsprop":
            d = self._hp("rho", 0.9)
            eps = self._hp("epsilon", 1e-7)
            centered = hp.get("centered", False)
            mom = hp.get("momentum") or None
            if mom is not None:
                mom = self._hp("momentum", None)
            nu, mu, trace, out = {}, {}, {}, {}
            for k, g in grads.items():
                dd, ee = _dev(d, g), _dev(eps, g)
                nu[k] = (1 - dd) * torch.square(g) + dd * state["nu"][k]
                if centered:
                    mu[k] = (1 - dd) * g + dd * state["mu"][k]
                    u = g * torch.rsqrt(nu[k] - torch.square(mu[k]) + ee)
                else:
                    u = g * torch.rsqrt(nu[k] + ee)
                u = u * (-lr)
                if mom is not None:
                    trace[k] = u + _dev(mom, g) * state["trace"][k]
                    u = trace[k]
                out[k] = u
            new["nu"] = nu
            if centered:
                new["mu"] = mu
            if mom is not None:
                new["trace"] = trace
            return out, new
        # adagrad
        eps = self._hp("epsilon", 1e-7)
        ss, out = {}, {}
        for k, g in grads.items():
            ss[k] = torch.square(g) + state["sum_of_squares"][k]
            inv = torch.where(ss[k] > 0, torch.rsqrt(ss[k] + _dev(eps, g)),
                              torch.zeros((), device=g.device))
            out[k] = inv * g * (-lr)
        new["sum_of_squares"] = ss
        return out, new

    def _muon(self, grads, state, params, lr, new):
        hp = self.hp
        momentum = hp.get("momentum", 0.95)
        nesterov = hp.get("nesterov", True)
        ns = (hp.get("ns_steps", 5), hp.get("muon_a", 3.4445),
              hp.get("muon_b", -4.7750), hp.get("muon_c", 2.0315))
        rms_rate = hp.get("rms_rate", 0.2)
        ratio = hp.get("adam_lr_ratio", 1.0)
        b1 = hp.get("adam_beta_1", 0.9)
        b2 = hp.get("adam_beta_2", 0.999)
        eps = hp.get("epsilon", 1e-7)
        adam_wd = hp.get("adam_weight_decay", 0.004)
        excl_emb = hp.get("exclude_embeddings", True)
        excl = tuple(hp.get("exclude_layers", ()) or ())
        alpha = _adam_alpha(new["count"], b1, b2)
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            m, v, p = state["mu"][k], state["nu"][k], params[k]
            adamw = (g.dim() != 2 or (excl_emb and "embedding" in k.lower())
                     or any(re.search(e, k) for e in excl))
            if adamw:
                mu[k] = m + (g - m) * (1.0 - b1)
                nu[k] = v + (torch.square(g) - v) * (1.0 - b2)
                u = (lr * ratio) * alpha.to(g.device) * mu[k] / (
                    torch.sqrt(nu[k]) + eps)
                wd = adam_wd
            else:
                mu[k] = momentum * m + g
                nu[k] = v
                g_eff = g + momentum * mu[k] if nesterov else mu[k]
                o = _newton_schulz5(g_eff, *ns)
                if rms_rate is not None:
                    o = o * (math.sqrt(float(max(o.shape))) * rms_rate)
                u = lr * o
                wd = self.weight_decay
            if wd:
                u = u + lr * wd * p
            out[k] = -u
        new.update(mu=mu, nu=nu)
        return out, new

    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor]):
        """(updates, new state): ``params[k] + updates[k]`` is the step.
        With accumulation the clipping applies to the accumulated mean, as
        the chain sits inside ``MultiSteps`` in JAX."""
        if self.k <= 1:
            return self._inner(self._clip(grads), state, params)
        n = state["mini_step"]
        acc = {k: state["acc_grads"][k] + (g - state["acc_grads"][k])
               / (n + 1).to(F32) for k, g in grads.items()}
        emit = int(n) == self.k - 1
        if not emit:
            new = dict(state, mini_step=n + 1, acc_grads=acc)
            return {k: torch.zeros_like(g) for k, g in grads.items()}, new
        inner = {k: v for k, v in state.items()
                 if k not in ("mini_step", "acc_grads")}
        out, inner_new = self._inner(self._clip(acc), inner, params)
        new = dict(inner_new, mini_step=torch.zeros_like(n),
                   acc_grads={k: torch.zeros_like(v) for k, v in acc.items()})
        return out, new

    def fuses(self, params: dict[str, torch.Tensor]) -> bool:
        """Whether :meth:`apply` takes the fused kernel for ``params``:
        Adam or AdamW, no accumulation, no ``global_clipnorm``, and every
        parameter a CUDA f32 tensor. Read from the settings and the
        tensors alone."""
        return (self.name in ("adam", "adamw") and self.k <= 1
                and not self.global_clipnorm and bool(params)
                and all(p.is_cuda and p.dtype == F32
                        for p in params.values()))

    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: dict):
        """One step **in place**: ``params`` (tensors or parameters by
        flax path) take the update, and ``(new state, gradient norm)``
        come back, the norm that of the unclipped ``grads``
        (:func:`global_norm`). Where :meth:`fuses` holds, one kernel pair
        updates the parameters and the state's ``mu`` and ``nu`` tensors
        in place (the dicts keep their keys and tensors) and the step
        neither copies to the card nor waits for it; otherwise
        :meth:`update` and ``p.add_`` leaf by leaf. Counts the update
        under ``optimizer/fused_updates`` or ``optimizer/leaf_updates``."""
        with torch.no_grad():
            if self.fuses(params):
                spans.count("optimizer/fused_updates")
                return self._apply_fused(params, grads, state)
            spans.count("optimizer/leaf_updates")
            values = {k: p.detach() for k, p in params.items()}
            updates, state = self.update(grads, state, values)
            for k, p in params.items():
                p.add_(updates[k])
            return state, global_norm(grads)

    def _apply_fused(self, params, grads, state):
        from jaeger_tpu_torch.ops.fused_adamw import fused_adamw_

        hp = self.hp
        b1 = hp.get("beta_1", 0.9)
        b2 = hp.get("beta_2", 0.999)
        count = state["count"] + 1
        norm = fused_adamw_(
            flax_order(params), params, grads, state["mu"], state["nu"],
            lr=float(self._rate(state)),
            alpha=float(_adam_alpha(count, b1, b2)), b1=b1, b2=b2,
            eps=hp.get("epsilon", 1e-7),
            weight_decay=self.weight_decay if self.name == "adamw" else 0.0,
            clipnorm=float(self.clipnorm) if self.clipnorm else None)
        return dict(state, count=count), norm


def make_optimizer(name: str = "adam", params: dict | None = None,
                   accumulation_steps: int = 1) -> Optimizer:
    return Optimizer(name, params, accumulation_steps)


def get_learning_rate(state: dict) -> float | None:
    """The current constant learning rate, or None for a schedule."""
    lr = state.get("learning_rate")
    return None if lr is None else float(lr)


def set_learning_rate(state: dict, lr: float) -> dict:
    """The state with the constant learning rate replaced (f32; a no-op for
    a schedule), for ReduceLROnPlateau."""
    if "learning_rate" not in state:
        return state
    return dict(state, learning_rate=_f32(lr))
