"""Seeded weights, made on the device in one draw.

Every leaf that :func:`~benchmark.reference.model.param_specs` lists comes
from one ``randn`` of the whole model's size on ``device``, drawn from a
generator seeded with the run's seed, then shifted and scaled by the
leaf's kind: kernels ``N(0, 1 / fan_in)``, the token embedding ``N(0,
1)``, biases and DYT / norm offsets ``N(0, 0.1^2)``, gains ``1 + N(0,
0.1^2)``, DYT's alpha ``0.5 + N(0, 0.05^2)``, moving means ``N(0,
0.1^2)`` and moving variances ``exp(N(0, 0.1^2))``. The weights are the
benchmark's own input: the program gets them loaded by name, the
reference reads them as they were made.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import param_specs


def seeded_weights(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    specs = param_specs(model_cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            v = z / math.sqrt(fan_in)
        elif kind == "embedding":
            v = z
        elif kind == "gamma":
            v = 1.0 + 0.1 * z
        elif kind == "alpha":
            v = 0.5 + 0.05 * z
        elif kind == "variance":
            v = torch.exp(0.1 * z)
        else:  # bias, beta, mean
            v = 0.1 * z
        out[name] = v.clone()
    return out
