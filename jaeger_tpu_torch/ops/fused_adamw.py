"""The Adam / AdamW update of a train step as one kernel pair on the card.

``csrc/fused_adamw.cu`` replaces no Pallas kernel: the JAX package's
update is optax's chain (``jaeger_tpu/train/optimizers.py``), which XLA
fuses. Its plain version is the port's per-leaf update,
:meth:`jaeger_tpu_torch.train.optimizers.Optimizer.update` followed by the
in-place adds and :func:`~jaeger_tpu_torch.train.optimizers.global_norm`,
which walks the leaves from Python: about 25 small launches and one
blocking copy of a CPU scalar a leaf (1,381 top-level ops over the
flagship's 49 leaves), so the host, not the card, set the step's pace.
:meth:`Optimizer.apply` takes :func:`fused_adamw_` for Adam and AdamW on
CUDA f32 parameters and the per-leaf update for everything else.

For each leaf, with ``ss`` its gradient's sum of squares and ``m`` the
clip norm (Keras' per-variable ``clipnorm``; none when unset)::

    g' = g * (m / max(sqrt(ss), m))
    mu = b1 mu + (1 - b1) g'        nu = b2 nu + (1 - b2) g'^2
    u = alpha mu / (sqrt(nu) + eps) + wd p        p += u * (-lr)

and the gradient norm ``sqrt(sum of ss)``, the leaves added in the order
the caller gives (flax order). ``lr`` and ``alpha`` come from the host as
floats, so no step copies a scalar to the card or waits for it.

The kernel pair: launch 1 writes each chunk's sum of squares (one block
a chunk of :data:`CHUNK` elements, a slot of its own in a scratch buffer:
no atomics); launch 2 adds its leaf's slots in order, forms the clip
factor and updates its chunk of p, mu and nu in place, and one more
block adds every slot, leaf by leaf, into the norm. The leaf table is the
kernels' 4 KB parameter block; more than :data:`MAX_LEAVES` leaves are
cut into several tables (:func:`leaf_groups`), launched in order. Bound:
bytes, 28 a parameter (read p, g, mu, nu; write p, mu, nu): 19.2 MB for
the flagship, 5.7 us at 3.35 TB/s. ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: elements a block of either kernel takes
CHUNK = 4096
#: leaves a table holds (the C source's MAX_LEAVES)
MAX_LEAVES = 80
#: the C source's flags
FLAG_CLIP, FLAG_DECAY, FLAG_NORM = 1, 2, 4

#: kernel launches since the last reset (set to 0 to reset)
launches = {"fused_adamw": 0}


class Leaf(ctypes.Structure):
    """The C source's ``Leaf``."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("chunk0", ctypes.c_int),
                ("chunks", ctypes.c_int)]


class Table(ctypes.Structure):
    """The C source's ``Table``: the hyperparameters as f32 (each rounded
    from its Python float, as torch rounds a scalar operand), the flags,
    this table's leaves and chunks, the scratch slots and the norm."""

    _fields_ = [("lr", ctypes.c_float), ("alpha", ctypes.c_float),
                ("b1", ctypes.c_float), ("c1", ctypes.c_float),
                ("b2", ctypes.c_float), ("c2", ctypes.c_float),
                ("eps", ctypes.c_float), ("wd", ctypes.c_float),
                ("clip", ctypes.c_float), ("flags", ctypes.c_int),
                ("leaves", ctypes.c_int), ("chunks", ctypes.c_int),
                ("chunk0", ctypes.c_int), ("total_chunks", ctypes.c_int),
                ("partials", ctypes.c_void_p), ("norm", ctypes.c_void_p),
                ("leaf", Leaf * MAX_LEAVES)]


#: the C entry's arguments: the table, its size, the stream
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _lib():
    from jaeger_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_adamw")
    fn = lib.jt_fused_adamw
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    lib.jt_fused_adamw_table_bytes.restype = ctypes.c_int
    got = lib.jt_fused_adamw_table_bytes()
    if got != ctypes.sizeof(Table):
        raise RuntimeError(f"fused_adamw: the C table has {got} bytes, the "
                           f"wrapper's {ctypes.sizeof(Table)}")
    return fn


def leaf_groups(sizes) -> list[list[int]]:
    """The leaves of each table, by index into ``sizes`` (elements a leaf,
    in the caller's order): the non-empty leaves in that order, cut every
    :data:`MAX_LEAVES`."""
    live = [i for i, n in enumerate(sizes) if n > 0]
    return [live[i:i + MAX_LEAVES] for i in range(0, len(live), MAX_LEAVES)]


def chunk_count(sizes) -> int:
    """Blocks of one kernel over leaves of ``sizes`` elements."""
    return sum(-(-n // CHUNK) for n in sizes)


def leaf_tables(leaves, *, lr, alpha, b1, b2, eps, partials, norm,
                weight_decay=0.0, clipnorm=None) -> list[Table]:
    """The tables of one update. ``leaves`` lists ``(p, g, mu, nu)``
    tensors (contiguous, f32, one shape each) in the norm's order;
    ``partials`` and ``norm`` are the addresses of the scratch slots (one
    float2 a chunk: :func:`chunk_count`) and of the norm. Only the last
    table writes the norm."""
    sizes = [p.numel() for p, _, _, _ in leaves]
    groups = leaf_groups(sizes)
    total = chunk_count(sizes)
    flags = ((FLAG_CLIP if clipnorm else 0)
             | (FLAG_DECAY if weight_decay else 0))
    tables, chunk = [], 0
    for gi, group in enumerate(groups):
        t = Table(lr=lr, alpha=alpha, b1=b1, c1=1.0 - b1, b2=b2, c2=1.0 - b2,
                  eps=eps, wd=weight_decay, clip=float(clipnorm or 0.0),
                  flags=flags | (FLAG_NORM if gi == len(groups) - 1 else 0),
                  leaves=len(group), chunk0=chunk, total_chunks=total,
                  partials=partials, norm=norm)
        for j, i in enumerate(group):
            p, g, m, v = leaves[i]
            n = sizes[i]
            t.leaf[j] = Leaf(p=p.data_ptr(), g=g.data_ptr(), mu=m.data_ptr(),
                             nu=v.data_ptr(), n=n, chunk0=chunk,
                             chunks=-(-n // CHUNK))
            chunk += t.leaf[j].chunks
        t.chunks = chunk - t.chunk0
        tables.append(t)
    return tables


def _leaf(key, p, g, m, v, dev):
    for name, t in (("parameter", p), ("mu", m), ("nu", v)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"fused_adamw: {name} {key} is {t.dtype} on "
                             f"{t.device}, expected float32 on {dev}")
        if t.shape != p.shape or not t.is_contiguous():
            raise ValueError(f"fused_adamw: {name} {key} must be contiguous "
                             f"and of shape {tuple(p.shape)}")
    if g.device != dev or g.dtype != torch.float32 or g.shape != p.shape:
        raise ValueError(f"fused_adamw: gradient {key} must be float32 on "
                         f"{dev} and of shape {tuple(p.shape)}")
    return p, g.contiguous(), m, v


def fused_adamw_(keys, params, grads, mu, nu, *, lr: float, alpha: float,
                 b1: float, b2: float, eps: float, weight_decay: float = 0.0,
                 clipnorm: float | None = None) -> torch.Tensor:
    """One Adam / AdamW update of ``params``, ``mu`` and ``nu`` **in
    place** (dicts of CUDA f32 tensors by key; parameters, ``mu`` and
    ``nu`` contiguous) from ``grads``; returns the unclipped gradients'
    global norm (a 0-dim f32 tensor on the card), the leaves added in the
    order of ``keys``. Launches and returns without waiting for the card;
    raises on anything else the kernels do not take."""
    dev = params[keys[0]].device
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw: runs on CUDA tensors, got {dev}")
    leaves = [_leaf(k, params[k], grads[k], mu[k], nu[k], dev) for k in keys]
    total = chunk_count(p.numel() for p, _, _, _ in leaves)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    if total == 0:
        return norm.zero_()
    partials = torch.empty((total, 2), dtype=torch.float32, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for t in leaf_tables(leaves, lr=lr, alpha=alpha, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, clipnorm=clipnorm,
                         partials=partials.data_ptr(),
                         norm=norm.data_ptr()):
        err = fn(ctypes.byref(t), ctypes.sizeof(t), stream)
        if err != 0:
            raise RuntimeError(f"fused_adamw kernel launch failed: CUDA "
                               f"error {err}")
        launches["fused_adamw"] += 2
    return norm
