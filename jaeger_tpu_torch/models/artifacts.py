"""Model bundles: load a JAX bundle, carry flax weights across, or init.

Counterpart of `jaeger_tpu/models/artifacts.py`. A bundle is a directory
holding ``params.msgpack`` (flax-serialized ``params`` and
``batch_stats``), ``project.yaml`` (the training config) and
``classes.yaml`` (the label map). The port reads the msgpack without
flax: flax writes every array as msgpack extension type 1 holding
``(shape, dtype name, C-order bytes)``, which ``msgpack`` and numpy
decode. ``msgpack`` and ``yaml`` are imported inside the functions that
need them.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.utils.config import load_model_config
from jaeger_tpu_torch.utils.devices import resolve_device

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
#: flax collections that hold the inference weights
_COLLECTIONS = ("params", "batch_stats")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Reassemble arrays that flax split into ``__msgpack_chunked_array__``
    dicts (only very large arrays are chunked)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        chunks = [tree["chunks"][k] for k in sorted(tree["chunks"], key=int)]
        shape = tuple(tree["shape"][k] for k in sorted(tree["shape"], key=int))
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str | Path) -> dict:
    """A flax ``params.msgpack`` as a nested dict of numpy arrays."""
    import msgpack

    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook,
                           raw=False)
    return _unchunk(tree)


def params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Flax variables (numpy leaves under ``params`` / ``batch_stats``)
    -> the port's state dict: the flax path joined with dots. Conv kernels
    keep their ``(k, C_in, C_out)`` layout, which the fused kernel takes."""
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise NotImplementedError(
            f"variable collections {sorted(extra)} (int8 bundles) are not "
            f"yet ported to jaeger_tpu_torch")
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True))

    for coll in _COLLECTIONS:
        walk("", variables.get(coll, {}))
    return out


def _ext_default(obj):
    import msgpack

    if isinstance(obj, np.ndarray):
        payload = msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")),
                                use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialize {type(obj)}")


def save_model(state: dict[str, torch.Tensor], config: dict,
               path: str | Path, classes: dict | None = None) -> Path:
    """Write a bundle that both packages load: ``state`` (the port's state
    dict) as flax msgpack under ``params`` / ``batch_stats``, the config
    and the label map."""
    import msgpack
    import yaml

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *scopes, leaf = key.split(".")
        coll = ("batch_stats" if leaf in ("moving_mean", "moving_variance")
                else "params")
        node = tree[coll]
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = t.detach().cpu().float().numpy()
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    (path / "params.msgpack").write_bytes(
        msgpack.packb(tree, default=_ext_default, strict_types=True))
    (path / "project.yaml").write_text(yaml.safe_dump(config, sort_keys=False))
    if classes is None:
        label_map = config.get("model", config).get("class_label_map", [])
        classes = {int(e["label"]): str(e["class"]) for e in label_map}
    (path / "classes.yaml").write_text(yaml.safe_dump(classes))
    return path


def load_state(model: torch.nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Load ``state`` into ``model``; every model entry must be present.
    Entries of heads the port does not build at inference (the
    self-supervised ``projection``) are ignored; any other extra raises."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(k for k in set(state) - set(own)
                   if not k.startswith("projection."))
    if missing or extra:
        raise KeyError(f"weights do not match the model: missing {missing}, "
                       f"unexpected {extra}")
    for k, v in own.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(state[k].shape)}, model "
                             f"expects {tuple(v.shape)}")
    model.load_state_dict({k: state[k] for k in own})


def init_params(config: dict,
                generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded weights for ``config`` with flax's default initializers:
    glorot-uniform conv kernels, lecun-normal dense kernels, orthogonal
    embeddings, zero biases, DYT ``alpha_init``/1/0, BN 1/0 with moving
    statistics 0/1."""
    model = build_model(config)
    state = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if leaf == "kernel" and t.dim() == 3:        # conv (k, in, out)
            fan_in, fan_out = t.shape[0] * t.shape[1], t.shape[0] * t.shape[2]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            v = (torch.rand(t.shape, generator=generator) * 2 - 1) * lim
        elif leaf == "kernel":                       # dense (in, out)
            v = torch.randn(t.shape, generator=generator) / math.sqrt(
                t.shape[0])
        elif leaf == "embedding":
            v = torch.nn.init.orthogonal_(torch.empty(t.shape),
                                          generator=generator)
        elif leaf == "alpha":
            v = torch.full(t.shape, owner.alpha_init)
        elif leaf in ("gamma", "moving_variance", "layer_weights"):
            v = torch.ones(t.shape)
        else:                                        # bias, beta, means
            v = torch.zeros(t.shape)
        state[name] = v
    return state


def load_model(path: str | Path, dtype=torch.float32, device=None):
    """Load a JAX model bundle -> (model, config, classes).

    The model is in eval mode on ``device`` (default ``cuda``; raises
    without CUDA unless ``device="cpu"``).
    """
    import yaml

    dev = resolve_device(device)
    path = Path(path)
    if not (path / "params.msgpack").exists():
        raise NotImplementedError(
            f"{path} has no params.msgpack (int8 bundles are not yet ported "
            f"to jaeger_tpu_torch)")
    config = load_model_config(path / "project.yaml")
    model = build_model(config, dtype=dtype)
    load_state(model, params_from_jax(read_flax_msgpack(
        path / "params.msgpack")))
    classes_file = path / "classes.yaml"
    classes = (yaml.safe_load(classes_file.read_text())
               if classes_file.exists() else {})
    return model.to(dev).eval(), config, classes


def class_names_in_order(classes: dict) -> tuple[list[int], list[str]]:
    indices = sorted(int(k) for k in classes)
    return indices, [str(classes[i]) for i in indices]
