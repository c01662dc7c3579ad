"""Device selection for the port's entry points.

Counterpart of `jaeger_tpu/utils/devices.py`, which sets up JAX's
compile cache; the port has no compile step at run time, so what is left
is choosing the device. Every entry point (``load_model``,
``InferenceEngine``, ``run_core``, the CLI) runs on ``cuda`` unless the
caller names another device, and raises when CUDA is missing: nothing
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is not available.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "jaeger_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' (CLI: --device cpu) to run "
                "on the CPU")
        # f32 convolutions and matmuls in full f32 (cuDNN defaults to TF32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
