"""Quantized bundles: ``utils quantize`` and the int8 bundle loader.

Counterpart of `jaeger_tpu/models/conversion.py` (``export_stablehlo`` is
not ported). ``quantize_bundle`` writes the same three kinds of bundle as
the JAX package, as flax msgpack that both packages load:

* ``dynamic``: large float kernels stored as ``{"_q": int8, "_scale":
  f32}`` per output channel, dequantized at load (``load_quantized``);
* ``full_int8``: the same, plus a ``quant`` collection of calibrated
  ``{kernel_q, w_scale, act_scale}`` per conv, which switches those convs
  to int8 execution (``models/layers.py``, the ``int8_conv`` kernel);
* ``float16``: bfloat16 weights in ``params.msgpack``.

Calibration runs the port's model in bfloat16, as the JAX package does,
on the same synthetic windows (``_calibration_batches``, the same numpy
generator and seed: bases, so one set serves translated and nucleotide
models), and records each conv input's absmax (``layers.calibrating``,
folded across repeated calls of one conv, as the shared branch of a
branched model makes them). Every template takes ``full_int8``: the quant
tree names each calibrated conv by its module path, as JAX's
``_build_quant_tree`` does (``rep_branch/conv1d_0`` in branch mode,
``multi_scale_conv_<i>/branch_<b>``, ``parallel_branches_<i>_branch_<b>/
...``, the residual stacks of the attention templates). ``dynamic`` and
``float16`` bundles load as float weights and run the float path.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.models.artifacts import (load_state, params_from_jax,
                                               read_flax_msgpack,
                                               write_flax_msgpack)
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.models.layers import MaskedConv1D, calibrating
from jaeger_tpu_torch.utils.config import load_model_config
from jaeger_tpu_torch.utils.devices import resolve_device

QUANT_MODES = ("dynamic", "full_int8", "float16")

_QUANT_MIN_SIZE = 1024  # don't quantize tiny vectors (biases, norms)


def _quantize_tree(params, prefix=""):
    """Replace large float kernels with {int8 values, scale} dicts."""
    quantized = {}
    meta = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            q, m = _quantize_tree(value, path)
            quantized[key] = q
            meta.update(m)
        else:
            arr = np.asarray(value)
            if (
                arr.dtype in (np.float32, np.float64)
                and arr.size >= _QUANT_MIN_SIZE
                and arr.ndim >= 2
            ):
                # per-output-channel symmetric int8
                axes = tuple(range(arr.ndim - 1))
                scale = np.max(np.abs(arr), axis=axes) / 127.0
                scale = np.maximum(scale, 1e-12)
                q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
                quantized[key] = {"_q": q, "_scale": scale.astype(np.float32)}
                meta[path] = arr.shape
            else:
                quantized[key] = arr
    return quantized, meta


def _dequantize_tree(params):
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            if "_q" in value:
                out[key] = (
                    value["_q"].astype(np.float32) * value["_scale"]
                )
            else:
                out[key] = _dequantize_tree(value)
        else:
            out[key] = value
    return out


def _calibration_batches(crop_nt: int, n: int = 256, batch: int = 64,
                         seed: int = 0):
    """Synthetic calibration windows (random bases + soft-mask runs)."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(n, crop_nt)).astype(np.uint8)
    # a quarter of the windows get soft-mask runs so the calibrated range
    # covers masked (zeroed) activations too
    for i in range(0, n, 4):
        lo = int(rng.integers(0, max(1, crop_nt // 2)))
        # clamp the run length so tiny crops (crop_nt <= 20) still
        # calibrate instead of raising low >= high
        run_hi = max(2, crop_nt // 2)
        run_lo = min(10, run_hi - 1)
        hi = lo + int(rng.integers(run_lo, run_hi))
        bases[i, lo:hi] += 5  # soft-masked IDs 5-8
    lengths = np.full((n,), crop_nt, dtype=np.int32)
    for s in range(0, n, batch):
        yield bases[s:s + batch], lengths[s:s + batch]


def _build_quant_tree(params, calib):
    """Mirror the calib tree into {kernel_q, w_scale, act_scale} entries
    keyed by the owning conv module's path."""
    out = {}
    for key, val in calib.items():
        if not isinstance(val, dict):
            continue
        if "absmax" in val and not isinstance(val["absmax"], dict):
            kernel = np.asarray(params[key]["kernel"], dtype=np.float32)
            w_scale = np.max(np.abs(kernel), axis=(0, 1)) / 127.0
            w_scale = np.maximum(w_scale, 1e-12).astype(np.float32)
            kq = np.clip(np.round(kernel / w_scale), -127, 127)
            a_scale = max(float(val["absmax"]) / 127.0, 1e-8)
            out[key] = {
                "kernel_q": kq.astype(np.int8),
                "w_scale": w_scale,
                "act_scale": np.float32(a_scale),
            }
        else:
            sub = _build_quant_tree(params.get(key, {}), val)
            if sub:
                out[key] = sub
    return out


def calibrate_int8(model: torch.nn.Module, params: dict, crop_nt: int,
                   n: int = 256) -> dict:
    """Run the synthetic calibration batches through the float ``model``
    (on its device), recording each conv input's absmax, then quantize
    those convs' kernels per channel from ``params`` (the flax ``params``
    tree) -> the ``quant`` collection."""
    dev = next(model.parameters()).device
    with calibrating(model) as records, torch.inference_mode():
        for bases, lengths in _calibration_batches(crop_nt, n=n):
            model(torch.from_numpy(bases).to(dev),
                  torch.from_numpy(lengths).to(dev))
    calib: dict = {}
    for name, v in records.items():
        node = calib
        for scope in name.split("."):
            node = node.setdefault(scope, {})
        node["absmax"] = np.float32(v.item())
    if not calib:
        return {}
    return _build_quant_tree(params, calib)


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def quantize_bundle(model_path: str | Path, output_path: str | Path,
                    mode: str = "dynamic", device=None) -> dict:
    """Write a quantized variant of a model bundle (see the module
    docstring). ``full_int8`` calibrates on ``device`` (default ``cuda``).
    Returns size stats."""
    import yaml

    model_path = Path(model_path)
    output_path = Path(output_path)
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode: {mode}")
    output_path.mkdir(parents=True, exist_ok=True)
    config = load_model_config(model_path / "project.yaml")
    classes_file = model_path / "classes.yaml"
    classes = (yaml.safe_load(classes_file.read_text())
               if classes_file.exists() else {})
    variables = read_flax_msgpack(model_path / "params.msgpack")

    def write_meta(scheme: dict) -> None:
        (output_path / "project.yaml").write_text(
            yaml.safe_dump(config, sort_keys=False))
        (output_path / "classes.yaml").write_text(yaml.safe_dump(classes))
        (output_path / "quantization.yaml").write_text(
            yaml.safe_dump(scheme))

    orig = (model_path / "params.msgpack").stat().st_size
    if mode == "float16":
        def half(node):
            if isinstance(node, dict):
                return {k: half(v) for k, v in node.items()}
            arr = np.asarray(node)
            if arr.dtype == np.float32:
                return torch.from_numpy(arr).to(torch.bfloat16)
            return arr

        payload = {"params": half(variables["params"])}
        if "batch_stats" in variables:
            payload["batch_stats"] = variables["batch_stats"]
        write_flax_msgpack(payload, output_path / "params.msgpack")
        write_meta({"scheme": "bfloat16-weights"})
        new = (output_path / "params.msgpack").stat().st_size
        return {"original_bytes": orig, "quantized_bytes": new,
                "ratio": round(orig / max(new, 1), 2), "mode": mode}
    q_params, meta = _quantize_tree(variables["params"])
    payload = {"params": q_params}
    if "batch_stats" in variables:
        payload["batch_stats"] = variables["batch_stats"]
    scheme = "int8-per-channel-weights"
    quant_convs = 0
    if mode == "full_int8":
        # static quantization: calibrate activation scales at the bf16
        # execution dtype so the stored per-tensor ranges match what the
        # int8 path will see at predict time
        model = build_model(copy.deepcopy(config), dtype=torch.bfloat16)
        load_state(model, params_from_jax(
            {k: v for k, v in variables.items()
             if k in ("params", "batch_stats")}))
        model = model.to(resolve_device(device)).eval()
        quant = calibrate_int8(model, variables["params"], model.crop_nt)
        if quant:
            payload["quant"] = quant
            scheme = "int8-exec-static"
            quant_convs = _count_leaves(quant) // 3
    write_flax_msgpack(payload, output_path / "params_int8.msgpack")
    write_meta({"scheme": scheme, "quantized_kernels": len(meta),
                "int8_exec_convs": quant_convs})
    new = (output_path / "params_int8.msgpack").stat().st_size
    return {
        "original_bytes": orig, "quantized_bytes": new,
        "ratio": round(orig / max(new, 1), 2),
        "quantized_kernels": len(meta),
        "int8_exec_convs": quant_convs,
    }


def load_quantized(path: str | Path, dtype=torch.float32, device=None):
    """Load an int8 bundle -> (model, config, classes): weights
    dequantized in numpy f32 (``_q * _scale``); a ``quant`` collection
    switches its convs to int8 execution."""
    import yaml

    dev = resolve_device(device)
    path = Path(path)
    config = load_model_config(path / "project.yaml")
    raw = read_flax_msgpack(path / "params_int8.msgpack")
    variables = {"params": _dequantize_tree(raw["params"])}
    for coll in ("batch_stats", "quant"):
        if coll in raw:
            variables[coll] = raw[coll]
    model = build_model(config, dtype=dtype)
    load_state(model, params_from_jax(variables))
    classes_file = path / "classes.yaml"
    classes = (yaml.safe_load(classes_file.read_text())
               if classes_file.exists() else {})
    return model.to(dev).eval(), config, classes


def int8_conv_count(model: torch.nn.Module) -> int:
    """How many of the model's convs run on the int8 kernel."""
    return sum(isinstance(m, MaskedConv1D) and m.int8
               for m in model.modules())

