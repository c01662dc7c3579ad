"""Fused conv block: the Hopper port of the Pallas TPU kernel.

Replaces ``jaeger_tpu/ops/pallas_conv.py::fused_conv_block`` (kernel body
``_kernel`` at :40-63, ``pl.pallas_call`` at :107). For x ``(N, L, C)``
channels-last and w ``(k, C, C)``::

    y = act(sum_j x[n, l + j - pad_l, :] @ w[j]  (+ bias | DYT))

SAME padding, stride 1, dilation 1, ``pad_l = (k - 1) // 2``, f32
accumulation, written in x's dtype. With no extension argument the
semantics are exactly the Pallas kernel's: DYT mode
(``tanh(acc * alpha) * gamma + beta``) adds no bias, and ``"gelu"`` is the
exact erf form; ``"gelu_tanh"`` is the tanh form the model uses in bf16.
The keyword-only extensions carry the model's residual blocks
(``models/layers.py``):

* ``bias_then_dyt``: add ``bias``, then DYT (``MaskedConv1D`` then
  ``MaskedDYT``);
* ``in_mask`` ``(N, L)`` bool: input rows that are masked read as zero (the
  masked conv's input pre-zero);
* ``out_mask`` ``(N, L)`` bool: the epilogue writes +0.0 where it is false
  (DYT's re-zero);
* ``residual`` ``(N, L, C)``: added before the activation
  (``act(norm2(conv2) + shortcut)``).

The epilogue order is bias, DYT, out_mask, residual, activation.

On the H100 (``csrc/fused_conv_block.cu``): at the flagship shape (N =
12288, L = 500, C = 128, k = 5) a call is 1.0e12 bf16 FLOPs against
3.1 GB of bf16 in and out, so the card's tensor-core peak and its memory
rate both allow about 1 ms. bf16 runs a persistent kernel, about one CTA
per SM, that keeps its block of the weights resident in shared memory,
loads x tiles with their halo by TMA into an mbarrier ring fed by one
producer warp, runs the k shifted products as ``wgmma`` (A from
registers, B from the resident weights) and applies the whole epilogue
from the accumulator registers while a second warpgroup runs the next
tile's products. :func:`conv_plan` sizes it. f32 inputs use plain FMAs,
never TF32 (1.0e12 FLOPs at the flagship shape: 15.0 ms at the card's
67 TFLOP/s f32 rate): route ``f32_ring``, a persistent kernel whose CTAs
keep a column block of the weights resident (or, where its k taps do not
fit, stream it a tap block at a time) and whose warps each walk 32-row
units, tap block by tap block of at most 9 taps, through a ``cp.async``
ring of their own, with 8-row x CB / 8-column outer products in
registers and the epilogue from them. :func:`f32_plan` sizes it.

CPU tensors take :func:`reference_conv_block`, the plain PyTorch version;
CUDA tensors launch the kernel or raise. ``launches`` counts kernel
launches, ``route_launches`` the same by route.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

#: kernel launches since the last reset (set to 0 to reset)
launches = 0
#: launches by route ("wgmma": bf16; "f32_ring": f32)
route_launches: collections.Counter = collections.Counter()

_ACT_IDS = {None: 0, "none": 0, "linear": 0, "relu": 1, "tanh": 2,
            "gelu": 3, "gelu_exact": 3, "gelu_tanh": 4}


def _activation(y: torch.Tensor, act: str | None) -> torch.Tensor:
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported activation {act!r}")
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "tanh":
        return torch.tanh(y)
    if act in ("gelu", "gelu_exact"):
        return F.gelu(y)
    if act == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    return y


def _epilogue_args(bias, dyt, use_dyt, bias_then_dyt):
    """(bias or None, dyt or None) as the kernel applies them."""
    if use_dyt:
        if dyt is None:
            raise ValueError("use_dyt=True needs dyt")
        return (bias if bias_then_dyt else None), dyt
    if bias_then_dyt:
        raise ValueError("bias_then_dyt needs use_dyt=True")
    return bias, None


def reference_conv_block(x, w, bias=None, dyt=None, act="none",
                         use_dyt=False, *, bias_then_dyt=False,
                         in_mask=None, out_mask=None, residual=None):
    """Plain PyTorch version of :func:`fused_conv_block` (same signature).

    The k shifted products accumulate in f32; the epilogue runs in f32
    and the result is cast to x's dtype once.
    """
    n, length, c = x.shape
    k = w.shape[0]
    pad_l = (k - 1) // 2
    bias, dyt = _epilogue_args(bias, dyt, use_dyt, bias_then_dyt)
    if in_mask is not None:
        x = torch.where(in_mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
    xf = F.pad(x.float(), (0, 0, pad_l, k - 1 - pad_l))
    wf = w.to(x.dtype).float()
    y = xf[:, 0:length] @ wf[0]
    for j in range(1, k):
        y = y + xf[:, j:j + length] @ wf[j]
    if bias is not None:
        y = y + bias.float()
    if dyt is not None:
        dyt = dyt.float()
        y = torch.tanh(y * dyt[0]) * dyt[1] + dyt[2]
    if out_mask is not None:
        y = torch.where(out_mask[..., None], y, torch.zeros((), device=y.device))
    if residual is not None:
        y = y + residual.float()
    return _activation(y, act).to(x.dtype)


#: shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
#: output rows per tile of the bf16 kernel (one wgmma M)
_TL = 64


def conv_plan(c: int, k: int, dtype=torch.bfloat16) -> dict:
    """The kernel's launch plan for C channels and k taps, or ValueError.

    bf16: ``cb`` output channels per CTA, the largest of 128, 64, 32, 16
    that divides C and leaves room for a ring of at least 2 x-tile
    stages beside the resident ``k * C * cb`` weights; ``kw`` channels per
    TMA box (64, 32 or 16: the box is ``kw * 2`` bytes wide, the swizzle
    width); ``stages`` (2-4); ``smem`` bytes, the kernel's layout
    (weights, ring, per-channel parameters, barriers, 1 KB alignment
    slack), which the C entry recomputes and must equal. f32: see
    :func:`f32_plan`.
    """
    if c <= 0 or c % 16:
        raise ValueError(f"C={c}: the kernel takes C % 16 == 0")
    if dtype == torch.float32:
        return f32_plan(c, k)
    rows = _TL + k - 1
    if rows > 256 or k + _TL // 8 > 64:
        raise ValueError(f"k={k}: the bf16 kernel takes k <= 56 (a TMA box "
                         f"of 64 + k - 1 rows, in_mask bits in one word)")
    kw = 64 if c % 64 == 0 else 32 if c % 32 == 0 else 16
    for cb in (128, 64, 32, 16):
        if c % cb:
            continue
        for stages in (4, 3, 2):
            smem = plan_bytes(c, k, cb, kw, stages)
            if smem <= SMEM_LIMIT:
                return dict(cb=cb, kw=kw, stages=stages, smem=smem)
    raise ValueError(f"C={c}, k={k}: k * C * 16 bf16 weights and two "
                     f"x stages of {64 + k - 1} x C exceed {SMEM_LIMIT} B "
                     f"of shared memory")


#: the f32 ring kernel: output rows of a warp's unit, its warps a CTA,
#: channels per ring stage, the most taps a tap block (its register
#: window) holds, and its column blocks
F32_TILE = 32
F32_WARPS = 8
F32_CHUNK = 16
F32_MAX_TAPS = 9
_F32_CBS = (64, 32, 16)


def check_f32_shape(c: int, k: int) -> None:
    """ValueError unless the f32 kernel takes C channels and k taps: C %
    16 == 0, C <= 128 or C % 128 == 0, and a 64 + k - 1 row tile of C f32
    with one weight tap of C x min(C, 128) f32 within shared memory (the
    set of (C, k) the f32 kernel has taken since its first version)."""
    if c <= 0 or c % 16:
        raise ValueError(f"C={c}: the kernel takes C % 16 == 0")
    if c > 128 and c % 128:
        raise ValueError(f"C={c}: the f32 kernel takes C <= 128 or "
                         f"C % 128 == 0")
    smem = ((_TL + k - 1) * c + c * min(c, 128)) * 4
    if k < 1 or smem > SMEM_LIMIT:
        raise ValueError(f"C={c}, k={k}: the f32 kernel takes k >= 1 and "
                         f"(64 + k - 1) x C + C x min(C, 128) f32 within "
                         f"{SMEM_LIMIT} B ({smem} B)")


def f32_tap_blocks(k: int, taps: int) -> tuple[int, int]:
    """(blocks, largest): the tap blocks of the f32 kernel for k taps whose
    weight buffer holds ``taps`` (k: resident, at most ``F32_MAX_TAPS`` a
    block; fewer: streamed, at most ``taps`` a block); block b has the taps
    ``[b k // blocks, (b + 1) k // blocks)``."""
    most = taps if taps < k else F32_MAX_TAPS
    blocks = -(-k // most)
    return blocks, -(-k // blocks)


def f32_plan_bytes(c: int, k: int, cb: int, stages: int,
                   taps: int | None = None) -> int:
    """Shared memory of the f32 ring kernel's layout: the weights (``taps``
    = k, the default: all ``k * C * cb`` f32 resident; fewer: two buffers
    of ``taps * C * cb`` f32), 4 x cb f32 parameters and each of the
    ``F32_WARPS`` warps' rings of ``stages`` stages of its unit's
    ``F32_TILE`` + largest tap block - 1 rows x ``F32_CHUNK`` f32."""
    taps = k if taps is None else taps
    rows = F32_TILE + f32_tap_blocks(k, taps)[1] - 1
    buffers = 1 if taps == k else 2
    return (buffers * 4 * taps * c * cb + 16 * cb
            + F32_WARPS * stages * rows * F32_CHUNK * 4)


def _f32_fmas_per_load(cb: int, taps: int) -> float:
    """FMAs a thread of the f32 ring kernel does per shared-memory load in
    a tap block of ``taps`` taps at column block ``cb``: per 4 channels
    ``8 + taps - 1`` window loads and ``4 * taps`` weight loads of CB / 8
    columns (two float4 loads at cb 64), ``4 * taps * 8 * cb / 8``
    FMAs."""
    weight_loads = 2 if cb == 64 else 1
    return 4 * taps * cb / ((7 + taps) + 4 * taps * weight_loads)


def f32_plan(c: int, k: int) -> dict:
    """The f32 launch plan for C channels and k taps, or ValueError
    (:func:`check_f32_shape`'s set).

    Route ``f32_ring`` (persistent, each warp its own ``cp.async`` ring
    of x rows, tap block by tap block, 8 x CB / 8 outer products a
    thread), in this order of preference (as ``chip_smoke.py --f32
    --sweep`` measured it on the H100): all k taps resident (``taps`` =
    k) at a column block
    ``cb`` of 64 or 32, the largest that fits with at least 2 ring stages,
    ``stages`` (2-4) the most that fit; else, where C % 32 == 0, the
    weights streamed (2 ring stages, two buffers of ``taps`` < k taps, at
    most ``F32_MAX_TAPS``) at the (cb 64 or 32, taps) that fits with the
    most FMAs per shared load (:func:`_f32_fmas_per_load`); else resident
    at cb 16; else streamed at cb 16 with the most taps that fit. ``tile``
    the ``F32_TILE`` rows of a warp's unit and ``smem`` bytes
    (:func:`f32_plan_bytes`), which the C entry recomputes and must
    equal."""
    check_f32_shape(c, k)

    def resident(cbs):
        for cb in cbs:
            if c % cb:
                continue
            for stages in (4, 3, 2):
                smem = f32_plan_bytes(c, k, cb, stages)
                if smem <= SMEM_LIMIT:
                    return dict(route="f32_ring", cb=cb, kw=0,
                                tile=F32_TILE, taps=k, stages=stages,
                                smem=smem)
        return None

    def streamed(cbs):
        fits = [(_f32_fmas_per_load(cb, taps), cb, taps) for cb in cbs
                if c % cb == 0
                for taps in range(1, min(k - 1, F32_MAX_TAPS) + 1)
                if f32_tap_blocks(k, taps)[1] == taps
                and f32_plan_bytes(c, k, cb, 2, taps) <= SMEM_LIMIT]
        if not fits:
            return None
        _, cb, taps = max(fits)
        return dict(route="f32_ring", cb=cb, kw=0, tile=F32_TILE, taps=taps,
                    stages=2, smem=f32_plan_bytes(c, k, cb, 2, taps))

    plan = (resident((64, 32)) or streamed((64, 32)) or resident((16,))
            or streamed((16,)))
    if plan is None:
        raise ValueError(f"C={c}, k={k}: no f32 layout fits {SMEM_LIMIT} B")
    return plan


def plan_bytes(c: int, k: int, cb: int, kw: int, stages: int) -> int:
    """Shared memory of the bf16 kernel's layout: the resident weights, the
    ring of x stages (chunks of 64 + k - 1 rows x kw channels, each 1 KB
    aligned), 4 x cb f32 parameters, 2 x stages mbarriers and 1 KB of
    alignment slack."""
    def align(v):
        return -(-v // 1024) * 1024

    stage = c // kw * align((_TL + k - 1) * kw * 2)
    return (align(k * c * cb * 2) + stages * stage + 16 * cb + 16 * stages
            + 1024)


#: the C entry's arguments: dtype, 8 pointers, n_rows, L, C, k, act, cb,
#: kw, stages, smem bytes, SM count, stream
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
            + [ctypes.c_void_p])


@functools.cache
def _lib():
    from jaeger_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_conv_block")
    fn = lib.jt_fused_conv_block
    # every pointer and the stream as c_void_p: ctypes would pass a
    # Python int as a 32-bit C int
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def _check(name, t, shape, dtype, device, align=16):
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")
    return t


def fused_conv_block(x, w, bias=None, dyt=None, act="none", use_dyt=False,
                     *, bias_then_dyt=False, in_mask=None, out_mask=None,
                     residual=None):
    """SAME, stride-1, dilation-1 fused conv + (bias|DYT) + activation.

    See the module docstring for the extensions. ``dyt`` is ``(3, C)``
    (alpha, gamma, beta rows); ``bias`` ``(C,)``; both are used in f32.
    """
    if x.device.type == "cpu":
        return reference_conv_block(
            x, w, bias, dyt, act, use_dyt, bias_then_dyt=bias_then_dyt,
            in_mask=in_mask, out_mask=out_mask, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_block: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv_block: unsupported dtype {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (N, L, C), got {tuple(x.shape)}")
    n, length, c = x.shape
    k = w.shape[0]
    if tuple(w.shape) != (k, c, c):
        raise ValueError(f"w must be (k, {c}, {c}), got {tuple(w.shape)}")
    plan = conv_plan(c, k, x.dtype)
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported activation {act!r}")
    bias, dyt = _epilogue_args(bias, dyt, use_dyt, bias_then_dyt)
    dev = x.device
    x = _check("x", x, (n, length, c), x.dtype, dev)
    w = _check("w", w, (k, c, c), x.dtype, dev)
    bias = _check("bias", bias, (c,), torch.float32, dev, align=4)
    dyt = _check("dyt", dyt, (3, c), torch.float32, dev, align=4)
    in_mask = _check("in_mask", in_mask, (n, length), torch.bool, dev, 1)
    out_mask = _check("out_mask", out_mask, (n, length), torch.bool, dev, 1)
    residual = _check("residual", residual, (n, length, c), x.dtype, dev)
    return _launch(x, w, bias, dyt, act, in_mask, out_mask, residual, plan)


def _launch(x, w, bias, dyt, act, in_mask, out_mask, residual, plan):
    """Launch the kernel on checked, contiguous CUDA tensors with ``plan``
    (:func:`conv_plan`'s dict)."""
    global launches
    n, length, c = x.shape

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty_like(x)
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bf16 = x.dtype == torch.bfloat16
    # f32 passes the plan's weight taps a buffer holds where bf16 passes kw
    err = fn(1 if bf16 else 0, ptr(x), ptr(w),
             ptr(bias), ptr(dyt), ptr(in_mask), ptr(out_mask), ptr(residual),
             ptr(out), n, length, c, w.shape[0], _ACT_IDS[act], plan["cb"],
             plan["kw"] if bf16 else plan["taps"], plan["stages"],
             plan["smem"], sms, stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_block kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    route_launches[plan.get("route", "wgmma")] += 1
    return out
