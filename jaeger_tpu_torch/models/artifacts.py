"""Model bundles: load a JAX bundle, carry flax weights across, or init.

Counterpart of `jaeger_tpu/models/artifacts.py`. A bundle is a directory
holding ``params.msgpack`` (flax-serialized ``params`` and
``batch_stats``), ``project.yaml`` (the training config) and
``classes.yaml`` (the label map). The port reads the msgpack without
flax: flax writes every array as msgpack extension type 1 holding
``(shape, dtype name, C-order bytes)``, which ``msgpack`` and numpy
decode (``bfloat16`` leaves widen to float32 without ``ml_dtypes``). A
``quant`` collection (a full_int8 bundle's calibrated convs) switches
those convs to int8 execution; int8 bundles (``params_int8.msgpack``)
load through ``models/conversion.py``. ``msgpack`` and ``yaml`` are
imported inside the functions that need them.
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
_COLLECTIONS = ("params", "batch_stats", "quant")
#: leaf names of the ``quant`` collection (int8 execution of a conv)
QUANT_LEAVES = ("kernel_q", "w_scale", "act_scale")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """One flax array. ``bfloat16`` leaves (``utils quantize --mode
    float16`` bundles) decode to float32 without ``ml_dtypes``: the 16
    bits are the top half of the float32 pattern, so the widening is
    exact."""
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(
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
    """Flax variables (numpy leaves under ``params`` / ``batch_stats`` /
    ``quant``) -> the port's state dict: the flax path joined with dots.
    Conv kernels keep their ``(k, C_in, C_out)`` layout, which the kernels
    take; the ``quant`` collection's ``kernel_q`` stays int8."""
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise NotImplementedError(
            f"variable collections {sorted(extra)} are not yet ported to "
            f"jaeger_tpu_torch")
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            dtype = np.int8 if prefix.endswith(".kernel_q") else np.float32
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=dtype, copy=True))

    for coll in _COLLECTIONS:
        walk("", variables.get(coll, {}))
    return out


def _ext_default(obj):
    """flax's array encoding: numpy arrays and scalars, and bfloat16
    torch tensors (written as flax writes ``ml_dtypes.bfloat16``)."""
    import msgpack

    def pack(shape, name, data):
        return msgpack.packb((shape, name, data), use_bin_type=True)

    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(
            _EXT_NDARRAY, pack(obj.shape, obj.dtype.name, obj.tobytes("C")))
    if isinstance(obj, np.generic):
        arr = np.asarray(obj)
        return msgpack.ExtType(
            _EXT_NPSCALAR, pack(arr.shape, arr.dtype.name, arr.tobytes("C")))
    if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
        bits = obj.detach().cpu().contiguous().view(torch.int16).numpy()
        return msgpack.ExtType(
            _EXT_NDARRAY, pack(tuple(obj.shape), "bfloat16", bits.tobytes("C")))
    raise TypeError(f"cannot serialize {type(obj)}")


def write_flax_msgpack(tree: dict, path: str | Path) -> None:
    """Write a nested dict of arrays as flax's ``serialization.to_bytes``
    does, so that both packages read it."""
    import msgpack

    Path(path).write_bytes(
        msgpack.packb(tree, default=_ext_default, strict_types=True))


def flax_variables(state: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax`: the port's state dict as a
    flax variables tree of numpy arrays, in the state's order, under
    ``params``, ``batch_stats`` (the moving statistics) and ``quant``
    (int8 convs); empty collections are left out."""
    tree: dict = {"params": {}, "batch_stats": {}, "quant": {}}
    for key, t in state.items():
        *scopes, leaf = key.split(".")
        coll = ("batch_stats" if leaf in ("moving_mean", "moving_variance")
                else "quant" if leaf in QUANT_LEAVES else "params")
        node = tree[coll]
        for s in scopes:
            node = node.setdefault(s, {})
        t = t.detach().cpu()
        node[leaf] = (t.numpy() if t.dtype == torch.int8
                      else t.float().numpy())
    for coll in ("batch_stats", "quant"):
        if not tree[coll]:
            del tree[coll]
    return tree


def save_model(state: dict, config: dict, path: str | Path,
               classes: dict | None = None) -> Path:
    """Write a bundle that both packages load: ``state`` (the port's state
    dict, or a flax variables tree, which is written as it is) as flax
    msgpack under ``params`` / ``batch_stats`` (and ``quant`` when the
    model has int8 convs), the config without ``model.parallel.seq_axis``
    and the label map."""
    import yaml

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = (state if isinstance(state.get("params"), dict)
            else flax_variables(state))
    write_flax_msgpack(tree, path / "params.msgpack")
    # parallel.seq_axis is a run-time knob (sequence-sharded execution
    # needs an ambient mesh), not a property of the model: strip it so the
    # bundle loads anywhere; predict puts it back for --seq-shard
    mcfg = config.get("model", config)
    if (mcfg.get("parallel") or {}).get("seq_axis"):
        import copy

        config = copy.deepcopy(config)
        mcfg = config.get("model", config)
        mcfg.get("parallel", {}).pop("seq_axis", None)
        if not mcfg.get("parallel"):
            mcfg.pop("parallel", None)
    (path / "project.yaml").write_text(yaml.safe_dump(config, sort_keys=False))
    if classes is None:
        label_map = config.get("model", config).get("class_label_map", [])
        classes = {int(e["label"]): str(e["class"]) for e in label_map}
    (path / "classes.yaml").write_text(yaml.safe_dump(classes))
    return path


def load_state(model: torch.nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Load ``state`` into ``model``; its entries must be the model's, no
    more and no fewer (the ``projection`` head's included, which the model
    builds wherever the config has one). ``quant`` entries
    (``<conv>.kernel_q`` / ``w_scale`` / ``act_scale``) switch their conv to
    int8 execution."""
    for key in state:
        *scopes, leaf = key.split(".")
        if leaf == "kernel_q":
            conv = model.get_submodule(".".join(scopes))
            conv.set_quant(*(state[".".join([*scopes, name])]
                             for name in QUANT_LEAVES))
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
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
    """Seeded weights for ``config`` with flax's default initializers, the
    JAX model's distributions: glorot-uniform conv kernels, lecun-normal
    (truncated at two standard deviations) dense and attention kernels,
    orthogonal embeddings, ``translated_embedding`` and pooler gates,
    zero biases, DYT ``alpha_init``/1/0, norms 1/0, BN moving statistics
    0/1; the BiLSTM's input kernels glorot-uniform, recurrent kernels
    orthogonal, biases 0 with the forget slice ``[U:2U]`` at 1 (Keras
    ``unit_forget_bias``); the Hyena filters' ``alphas`` ``10**U(-3, 0)``.
    The numbers are the generator's, not JAX's."""
    from jaeger_tpu_torch.models.layers import (DenseGeneral, MaskedBiLSTM,
                                                MaskedConv1D)

    def glorot_uniform(shape, fan_in, fan_out):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=generator) * 2 - 1) * lim

    model = build_model(config)
    state = {}
    for name, t in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(path)
        if leaf == "kernel" and isinstance(owner, MaskedConv1D):
            v = glorot_uniform(t.shape, t.shape[0] * t.shape[1],
                               t.shape[0] * t.shape[2])
        elif isinstance(owner, MaskedBiLSTM):
            kind = leaf.split("_", 1)[1]
            if kind == "kernel":
                v = glorot_uniform(t.shape, t.shape[0], t.shape[1])
            elif kind == "recurrent":
                v = torch.nn.init.orthogonal_(torch.empty(t.shape),
                                              generator=generator)
            else:
                v = torch.zeros(t.shape)
                v[owner.units: 2 * owner.units] = 1.0
        elif leaf == "alphas":
            v = 10.0 ** (torch.rand(t.shape, generator=generator) * 3 - 3)
        elif leaf == "kernel" and (name.startswith("translated_embedding")
                                   or path.endswith("pool.gate")):
            v = torch.nn.init.orthogonal_(torch.empty(t.shape),
                                          generator=generator)
        elif leaf == "kernel":               # dense (in, out), DenseGeneral
            # variance_scaling(1, fan_in, truncated_normal): the stddev of
            # a unit normal truncated at +-2 is 0.8796...
            fan_in = (math.prod(owner.in_shape)
                      if isinstance(owner, DenseGeneral) else t.shape[0])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            v = torch.nn.init.trunc_normal_(
                torch.empty(t.shape), std=std, a=-2 * std, b=2 * std,
                generator=generator)
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
    without CUDA unless ``device="cpu"``). int8 bundles (``utils
    quantize`` output: ``params_int8.msgpack`` and no ``params.msgpack``)
    load through :func:`jaeger_tpu_torch.models.conversion.load_quantized`.
    """
    import yaml

    dev = resolve_device(device)
    path = Path(path)
    if (path / "params_int8.msgpack").exists() and not (
            path / "params.msgpack").exists():
        from jaeger_tpu_torch.models.conversion import load_quantized

        return load_quantized(path, dtype=dtype, device=dev)
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
