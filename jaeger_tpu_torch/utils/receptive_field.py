"""Copy of `jaeger_tpu/utils/receptive_field.py`.

Receptive-field computation from a config layer stack.

Parity target: reference ``utils/receptive_field.py:1-150`` — static RF
over the length axis: convs add ``(k-1)*dilation``, residual stacks add
``block_size * (k-1)*dilation`` (the reference's accounting, kept for
parity), BiLSTM / axial / length-attention make the RF the full sequence,
parallel branches take the max branch RF.
"""

from __future__ import annotations

import math
from typing import Any


def _conv_delta(kernel_size: int, dilation_rate: int) -> int:
    return (kernel_size - 1) * dilation_rate


def _attends_over_length(attention_axes) -> bool:
    if attention_axes is None:
        return False
    if isinstance(attention_axes, int):
        return attention_axes == 2
    return 2 in tuple(attention_axes)


def _walk(hidden_layers: list[dict[str, Any]], current: int | float):
    rf: int | float = current
    trace: list[tuple[str, int | float]] = []
    for layer in hidden_layers:
        name = layer.get("name", "unknown")
        cfg = layer.get("config") or {}
        if name == "masked_conv1d" or name == "conv1d":
            rf += _conv_delta(int(cfg.get("kernel_size", 1)),
                              int(cfg.get("dilation_rate", 1)))
        elif name == "multi_scale_conv":
            deltas = [
                _conv_delta(int(b.get("kernel_size", 1)),
                            int(b.get("dilation_rate", 1)))
                for b in cfg.get("branches", [])
            ]
            rf += max(deltas) if deltas else 0
        elif name == "residual_block":
            rf += int(cfg.get("block_size", 2)) * _conv_delta(
                int(cfg.get("kernel_size", 3)),
                int(cfg.get("dilation_rate", 1)),
            )
        elif name in ("masked_bilstm", "axial_attention", "hyena_block"):
            rf = math.inf
        elif name == "transformer_encoder" and _attends_over_length(
            cfg.get("attention_axes", 2)
        ):
            rf = math.inf
        elif name == "local_attention":
            if not math.isinf(rf):
                half = int(cfg.get("window_size", 0)) // 2
                rf += 2 * half * int(cfg.get("num_blocks", 1))
        elif name == "parallel_branches":
            branch_rfs = []
            for idx, branch in enumerate(cfg.get("branches", [])):
                b_rf, _ = _walk(branch.get("hidden_layers", []), rf)
                trace.append((f"parallel_branches.branch_{idx}", b_rf))
                branch_rfs.append(b_rf)
            if branch_rfs:
                rf = max(branch_rfs)
            continue
        trace.append((name, rf))
    return rf, trace


def compute_receptive_field(hidden_layers: list[dict[str, Any]]):
    rf, trace = _walk(hidden_layers, 1)
    return rf, [("input", 1)] + trace


def _fmt(rf) -> str:
    return "full sequence" if math.isinf(rf) else str(int(rf))


def receptive_field_summary(hidden_layers: list[dict[str, Any]],
                            crop_size: int | None = None) -> str:
    rf, trace = compute_receptive_field(hidden_layers)
    lines = [f"Receptive field: {_fmt(rf)}"]
    lines += [f"  {name}: {_fmt(v)}" for name, v in trace]
    if crop_size is not None:
        if not math.isinf(rf) and crop_size:
            coverage = min(100, int(rf / crop_size * 100))
            lines.append(f"  crop size: {crop_size} ({coverage}% coverage)")
        else:
            lines.append(f"  crop size: {crop_size}")
    return "\n".join(lines)
