"""The program under test, built from a configuration and the benchmark's
own weights."""

from __future__ import annotations

import copy

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_program(model_cfg: dict, weights: dict, precision: str, device):
    """The port's model (``models/builder.py``) in ``precision`` on
    ``device`` with ``weights`` loaded by name (``load_state`` refuses a
    missing or extra leaf, so the reference's layout is the program's)."""
    from jaeger_tpu_torch.models.artifacts import load_state
    from jaeger_tpu_torch.models.builder import build_model

    model = build_model({"model": copy.deepcopy(model_cfg)}, dtype=DTYPES[precision])
    model.to(device)
    load_state(model, weights)
    return model.eval()
