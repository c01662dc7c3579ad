"""Copy of `jaeger_tpu/models/ensemble.py`: model ensembles in PyTorch.

N trained bundles combined into one model by majority vote (``mv``),
``sum``, ``mean`` or ``none`` (the mean, as in the reference). An
ensemble bundle is a directory with an ``ensemble.yaml`` (``method`` and
the absolute ``members`` paths) written by ``utils combine-models``; the
members stay where they are. :class:`EnsembleModel` is an ``nn.Module``
that runs every member on the same inputs and combines their outputs; it
has no ``config``, so the engine plans no bounded-mask program for it, as
the JAX engine does not.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from jaeger_tpu_torch.models.artifacts import load_model

METHODS = ("mv", "sum", "mean", "none")


def _sum(s: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(s, axis=0)``: summed in f32, returned in s's dtype."""
    return s.sum(0, dtype=torch.float32).to(s.dtype)


class EnsembleModel(nn.Module):
    """The members (``models``, a ModuleList) and the combination rule.

    ``forward(bases, lengths, **kw)`` passes its arguments to every member
    and combines the outputs as ``jaeger_tpu/models/ensemble.py:50-91``:

    * only the keys every member returns are combined;
    * ``sum`` sums, ``mean`` and ``none`` average;
    * ``mv`` takes each example's majority class over the members'
      argmaxes (ties to the lowest class) and returns a prediction that is
      zero except at that class, which holds the mean of the members'
      logits there over every member whose logit there is not zero; every
      other key is averaged.
    """

    def __init__(self, models: list[nn.Module], method: str = "mean"):
        super().__init__()
        method = method.lower()
        if method not in METHODS:
            raise ValueError(f"unknown combination method {method!r}")
        self.models = nn.ModuleList(models)
        self.method = method

    @property
    def masking_enabled(self) -> bool:
        return any(getattr(m, "masking_enabled", True) for m in self.models)

    @property
    def crop_nt(self) -> int | None:
        """The largest member crop (None when one is unknown): the engine's
        dense program must be exact for every member."""
        crops = [getattr(m, "crop_nt", None) for m in self.models]
        if not crops or any(c is None for c in crops):
            return None
        return max(crops)

    def forward(self, *args, **kwargs) -> dict[str, torch.Tensor]:
        outs = [m(*args, **kwargs) for m in self.models]
        common = set(outs[0])
        for o in outs[1:]:
            common &= set(o)
        stacks = {k: torch.stack([o[k] for o in outs]) for k in common}
        if self.method == "sum":
            return {k: _sum(s) for k, s in stacks.items()}
        # jnp.mean: the f32 sum times f32(1 / M)
        result = {k: (s.sum(0, dtype=torch.float32) * (1.0 / len(outs))).to(
            s.dtype) for k, s in stacks.items()}
        if self.method in ("mean", "none"):
            return result
        preds = stacks["prediction"]                    # (M, B, C)
        n_classes = preds.shape[-1]
        votes = nn.functional.one_hot(preds.argmax(-1), n_classes).sum(0)
        majority = nn.functional.one_hot(votes.argmax(-1), n_classes).to(
            preds.dtype)[None]
        masked = preds * majority
        counts = _sum((masked != 0).to(preds.dtype))
        result["prediction"] = _sum(masked) / torch.clamp(counts, min=1.0)
        return result


def combine_models_core(model_paths: list[str], output_path: str,
                        method: str = "mean", device=None) -> Path:
    """Write an ensemble bundle of ``model_paths`` (each must load; it is
    loaded on ``device``, default ``cuda``)."""
    import yaml

    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    members = []
    for mp in model_paths:
        load_model(mp, device=device)
        members.append(str(Path(mp).resolve()))
    (output_path / "ensemble.yaml").write_text(
        yaml.safe_dump({"method": method, "members": members}))
    return output_path


def load_ensemble(path: str | Path, dtype=torch.float32, device=None):
    """An ensemble bundle -> (EnsembleModel, config, classes), the config
    and classes of the first member that has them."""
    import yaml

    spec = yaml.safe_load((Path(path) / "ensemble.yaml").read_text())
    models = []
    config = classes = None
    for mp in spec["members"]:
        model, cfg, cls = load_model(mp, dtype=dtype, device=device)
        models.append(model)
        config = config or cfg
        classes = classes or cls
    return (EnsembleModel(models, method=spec.get("method", "mean")),
            config, classes)


def is_ensemble(path: str | Path) -> bool:
    return (Path(path) / "ensemble.yaml").exists()
