"""Int8 conv: the Hopper port of the Pallas int8 conv kernel.

Replaces ``experiments/pallas_int8_conv.py::int8_conv_layer``
(``pl.pallas_call`` at :67-69, kernel body ``_kernel`` at :41-63) and
carries ``MaskedConv1D``'s int8 branch (``jaeger_tpu/models/layers.py``
:228-262). For x ``(N, L, C_in)`` channels-last and w ``(k, C_in, C_out)``
int8, stride ``s``, dilation ``d``::

    acc[n, l, :] = sum_j q[n, l*s + j*d - pad_l, :] @ w[j]    (int32, exact)

SAME (XLA's: ``L_out = ceil(L / s)``, ``pad_l`` the smaller half of
``(L_out - 1) s + d(k-1) + 1 - L``; at s 1 ``pad_l = d(k-1) // 2``,
``L_out = L``) or VALID (``pad_l = 0``, ``L_out = (L - d(k-1) - 1) // s +
1``). Two entry points share one kernel (``csrc/int8_conv.cu``):

* :func:`int8_conv_requant`: x int8, output
  ``clip(rint(f32(acc) * scale), -127, 127)`` as int8 with one combined f32
  ``scale``: the Pallas kernel's function (SAME).
* :func:`int8_conv_dequant`: x bf16 or f32, quantized as the kernel loads
  it, ``q = clip(rint(f32(x) * inv_act), -127, 127)`` (rows whose
  ``in_mask`` is false load as 0); the epilogue is ``f32(acc) * dq[c]``
  with ``dq = f32(w_scale) * f32(act_scale)``, then fused_conv_block's
  extensions in its order (bias, DYT, out_mask, residual, activation),
  written in x's dtype.

Rounding is half to even on both sides. C_in and C_out may be any
positive counts.

On the H100: at the Pallas chip shape (N = 12288, L = 500, C = 128, k = 5)
the requant form is 1.007e12 int8 operations (0.51 ms at the 1,979 TOP/s
peak) against 1.57 GB of int8 in and out (0.47 ms at 3.35 TB/s), so the
tensor cores bound it. The dequant form moves bf16 (3.15 GB, 0.94 ms;
1.41 ms with a residual) and is bound by bytes. :func:`int8_plan` picks
one of three routes before any launch. ``"wgmma"`` (the int8 and bf16
forms, C_in % 32 == 0) is a persistent kernel, about one CTA per SM, that
keeps its column block of the s8 weights resident in shared memory,
loads x tiles with their halo by TMA into an mbarrier ring fed by one
producer thread, has three more warps quantize each bf16 tile once into
an s8 tile, runs the k shifted products as s8 ``wgmma`` (A from
registers, B from the resident weights) and applies the epilogue from the
accumulators while a second warpgroup runs the next tile's products; the
residual tile arrives by TMA. ``"mma"`` (f32 inputs, C_in % 32 == 16, or
a shape whose weights and ring do not fit) is the first, simple
``mma.sync`` kernel. ``"ragged"`` takes C_in or C_out not a multiple of
16, and every stride above 1 (the dvf template's conv: one-hot
nucleotides, C_in 4, C_out 500, k 10, VALID, per launch at batch 2048
40.2 G int8 operations, 0.020 ms, against 1.01 GB of bf16 output, 0.300
ms; a strided flagship-width conv1, C 128, k 5, stride 2: 0.70 ms of bf16
in and out; both bound by bytes). Its resident kernel keeps a column
block's k taps in shared memory; two warpgroups take tiles of 64 output
positions in turn, each with a ring of x stages that 16-byte ``cp.async``
copies fill a tile ahead (the input rows as they lie in device memory,
in_mask beside them), quantizes a stage once into an s8 tile, runs s8
``wgmma`` with A from registers (the ``k * C_in`` contraction read
tap-major from the s8 tile through an offset table, at row ``r s + j
d``), and writes the epilogue from the accumulators through an output
image as streaming stores. Shapes whose stages and taps do not fit take
its staged kernel (the route's first: element-wise loads, weights
restaged a stage of taps at a time, ``mma.sync`` m16n8k32). A
route that fails raises; no other is ever tried.

CPU tensors take the plain versions :func:`reference_int8_conv_requant`
and :func:`reference_int8_conv_dequant`, which sum the integer products
exactly in float64 (every partial sum is an integer below 2**53); CUDA
tensors launch the kernel or raise. ``launches`` counts kernel launches,
``route_launches`` the same by route.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from jaeger_tpu_torch.ops.fused_conv import (_ACT_IDS, SMEM_LIMIT,
                                             _activation, _check,
                                             _epilogue_args)

#: kernel launches since the last reset (set to 0 to reset), and the same
#: by route (``clear()`` to reset)
launches = 0
route_launches: collections.Counter = collections.Counter()

#: rows per float64 chunk of the plain versions (bounds their memory)
_PLAIN_ROWS = 2048


def conv_geometry(length: int, k: int, dilation: int, padding: str,
                  stride: int = 1) -> tuple[int, int, int]:
    """(L_out, pad_l, pad_r) of a conv with XLA's SAME or VALID padding."""
    span = dilation * (k - 1)
    padding = padding.upper()
    if stride < 1:
        raise ValueError(f"stride {stride} must be >= 1")
    if padding == "SAME":
        l_out = -(-length // stride)
        total = max((l_out - 1) * stride + span + 1 - length, 0)
        return l_out, total // 2, total - total // 2
    if padding == "VALID":
        if length <= span:
            raise ValueError(f"VALID conv: length {length} <= span {span}")
        return (length - span - 1) // stride + 1, 0, 0
    raise ValueError(f"unsupported padding {padding!r}")


def _exact_conv(q: torch.Tensor, w: torch.Tensor, dilation: int,
                padding: str, stride: int = 1) -> torch.Tensor:
    """Integer conv of int8-valued q (N, L, C_in) and w (k, C_in, C_out) as
    float64 holding the exact int32 sums (|sum| < 127 * 127 * k * C_in,
    far below 2**53, so every product and partial sum is exact)."""
    k = w.shape[0]
    l_out, pad_l, pad_r = conv_geometry(q.shape[1], k, dilation, padding,
                                        stride)
    span = (l_out - 1) * stride + 1
    wf = w.double()
    chunks = []
    for s in range(0, q.shape[0], _PLAIN_ROWS):
        qf = F.pad(q[s:s + _PLAIN_ROWS].double(), (0, 0, pad_l, pad_r))
        acc = qf[:, 0:span:stride] @ wf[0]
        for j in range(1, k):
            acc += qf[:, j * dilation:j * dilation + span:stride] @ wf[j]
        chunks.append(acc)
    return torch.cat(chunks) if len(chunks) > 1 else chunks[0]


def _f32(v, device, name: str) -> torch.Tensor:
    """A float, 0-d or 1-element tensor as a (1,) f32 tensor on device."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if t.numel() != 1:
        raise ValueError(f"{name} must be one value, got {t.numel()}")
    return t


def reference_int8_conv_requant(x, w, scale, dilation: int = 1,
                                stride: int = 1):
    """Plain PyTorch version of :func:`int8_conv_requant`."""
    acc = _exact_conv(x, w, dilation, "SAME", stride)
    y = acc.float() * _f32(scale, x.device, "scale")
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def quantize_activation(x: torch.Tensor, inv_act) -> torch.Tensor:
    """``clip(round(f32(x) * inv_act), -127, 127)`` as f32 (layers.py:249)."""
    q = torch.round(x.float() * _f32(inv_act, x.device, "inv_act"))
    return torch.clamp(q, -127.0, 127.0)


def reference_int8_conv_dequant(x, w, inv_act, dq, bias=None, dyt=None,
                                act="none", use_dyt=False, *, dilation=1,
                                padding="same", stride=1,
                                bias_then_dyt=False, in_mask=None,
                                out_mask=None, residual=None):
    """Plain PyTorch version of :func:`int8_conv_dequant` (same
    signature). The epilogue runs in f32 with the multiply and the bias add
    as separate operations, and the result is cast to x's dtype once."""
    bias, dyt = _epilogue_args(bias, dyt, use_dyt, bias_then_dyt)
    q = quantize_activation(x, inv_act)
    if in_mask is not None:
        q = torch.where(in_mask[..., None], q,
                        torch.zeros((), device=q.device))
    y = _exact_conv(q, w, dilation, padding, stride).float() * dq.float()
    if bias is not None:
        y = y + bias.float()
    if dyt is not None:
        dyt = dyt.float()
        y = torch.tanh(y * dyt[0]) * dyt[1] + dyt[2]
    if out_mask is not None:
        y = torch.where(out_mask[..., None], y,
                        torch.zeros((), device=y.device))
    if residual is not None:
        y = y + residual.float()
    return _activation(y, act).to(x.dtype)


#: output rows per tile of the wgmma route (one wgmma M), and the s8
#: tiles between its quantizer warps and its consumer warpgroups
_TL = 64
_QSLOTS = 3
#: the mma route: output rows per CTA, shared-memory row padding, and the
#: budget that leaves room for two CTAs per SM
_MMA_TL = 128
_MMA_PAD = 16
_MMA_TARGET = 112 * 1024
#: the ragged route's staged kernel: weight and accumulator row padding
#: (bytes, words); its resident kernel: the bytes around an x stage's
#: 16-byte aligned span
_RG_WPAD = 16
_RG_OPAD = 8
_RG_SLACK = 48

_ESIZE = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}


def _align(v: int, a: int = 1024) -> int:
    return -(-v // a) * a


def int8_plan(c_in: int, c_out: int, k: int, dilation: int = 1,
              padding: str = "same", dtype=torch.bfloat16,
              stride: int = 1) -> dict:
    """The kernel's launch plan, or ValueError.

    ``dtype`` is x's: int8 (the requant form), bf16 or f32 (the dequant
    form). ``route`` ``"wgmma"`` takes int8 and bf16 with C_in % 32 == 0,
    C_out % 16 == 0 and a TMA box of ``64 + d(k-1)`` <= 256 rows: ``kw``
    bytes of C_in per weight / s8 chunk (128, 64 or 32: the swizzle
    width), ``cb`` output channels per CTA (the largest of 128, 64, 32, 16
    that divides C_out and leaves room for at least 2 ring ``stages``
    beside the resident ``k * C_in * cb`` weights), ``stages`` (2-4) and
    ``smem`` bytes (:func:`wgmma_plan_bytes`). Other multiples of 16 take
    ``route`` ``"mma"`` (``kw`` and ``stages`` 0, ``smem``
    :func:`mma_plan_bytes`). C_in or C_out not a multiple of 16, and every
    ``stride`` above 1, take ``route`` ``"ragged"`` (:func:`ragged_plan`).
    The C entry recomputes the layout and refuses a plan that disagrees.
    """
    if c_in <= 0 or c_out <= 0:
        raise ValueError(f"C_in={c_in}, C_out={c_out}: both must be >= 1")
    if k < 1 or dilation < 1 or stride < 1:
        raise ValueError(f"k={k}, dilation={dilation}, stride={stride}: "
                         f"each must be >= 1")
    if padding.upper() not in ("SAME", "VALID"):
        raise ValueError(f"unsupported padding {padding!r}")
    if dtype not in _ESIZE:
        raise ValueError(f"unsupported dtype {dtype}")
    if c_in % 16 or c_out % 16 or stride > 1:
        return ragged_plan(c_in, c_out, k, dilation, stride, dtype)
    if (dtype != torch.float32 and c_in % 32 == 0
            and _TL + dilation * (k - 1) <= 256):
        kw = 128 if c_in % 128 == 0 else 64 if c_in % 64 == 0 else 32
        for cb in (128, 64, 32, 16):
            if c_out % cb:
                continue
            for stages in (4, 3, 2):
                smem = wgmma_plan_bytes(c_in, k, dilation, cb, kw, stages,
                                        dtype)
                if smem <= SMEM_LIMIT:
                    return dict(route="wgmma", cb=cb, kw=kw, stages=stages,
                                smem=smem)
    cb = next(cb for cb in (128, 64, 32, 16) if c_out % cb == 0)
    return dict(route="mma", cb=cb, kw=0, stages=0,
                smem=mma_plan_bytes(c_in, k, dilation, cb))


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def ragged_pitch(cp: int, stride: int) -> int:
    """The resident kernel's s8 tile row bytes: ``cp``, padded when ``cp %
    16 == 0`` so that ``stride * pitch / 4`` is 4 mod 8 (an A fragment's
    eight rows on distinct banks)."""
    if cp % 16 == 0:
        for pad in range(0, 32, 4):
            if stride * ((cp + pad) // 4) % 8 == 4:
                return cp + pad
    return cp


def ragged_resident_bytes(c_in: int, k: int, dilation: int, cb: int,
                          ring: int, stride: int = 1, esize: int = 2,
                          wgs: int = 2) -> tuple[int, int]:
    """(``kp``, shared memory) of the ragged route's resident kernel: all
    ``k`` taps of the column block resident (``kp`` = ``k * cp`` rounded up
    to 32 bytes of ``cb`` rows, ``cp`` = C_in rounded up to 4), ``kp / 4``
    s32 contraction offsets and 5 x ``cb`` f32 epilogue parameters, then for
    each of the ``wgs`` warpgroups ``ring`` x stages (the ``63 s + d(k-1) + 1``
    input rows of 64 outputs at stride ``s``, ``esize`` bytes an element,
    as they lie in device memory, plus 48 bytes of alignment room) and
    ``ring`` in_mask stages, the s8 tile (``rows x ragged_pitch``) and the
    output image (64 rows of ``cb + 8`` elements: conflict-free stores of
    the accumulators' pairs); 1 KB of alignment slack."""
    cp = -(-c_in // 4) * 4
    rows = (_TL - 1) * stride + dilation * (k - 1) + 1
    kp = -(-k * cp // 32) * 32
    per_wg = (ring * (_round16(rows * c_in * esize + _RG_SLACK)
                      + _round16(rows + _RG_SLACK))
              + _round16(rows * ragged_pitch(cp, stride))
              + _TL * (cb + 8) * esize)
    return kp, kp * cb + kp + 20 * cb + wgs * per_wg + 1024


def ragged_plan_bytes(c_in: int, k: int, dilation: int, cb: int,
                      taps: int, stride: int = 1) -> tuple[int, int]:
    """(``kp``, shared memory) of the ragged route's staged kernel with
    ``taps`` weight taps a stage: the x tile of ``63 s + d(k-1) + 1`` rows
    (the input rows of 64 outputs at stride ``s``) of ``cp`` bytes (C_in
    rounded up to 4; the tile padded to 16 bytes), ``cb`` weight rows of
    ``kp + 16`` bytes (``kp`` = ``taps * cp`` rounded up to 32: one stage's
    contraction), 64 accumulator rows of ``cb + 8`` s32, the
    contraction's ``kp`` s32 x tile offsets and 5 x ``cb`` f32 epilogue
    parameters."""
    cp = -(-c_in // 4) * 4
    kp = -(-taps * cp // 32) * 32
    rows = (_TL - 1) * stride + dilation * (k - 1) + 1
    xs = -(-rows * cp // 16) * 16
    return kp, (xs + cb * (kp + _RG_WPAD) + _TL * (cb + _RG_OPAD) * 4
                + 4 * kp + 20 * cb)


def ragged_plan(c_in: int, c_out: int, k: int, dilation: int,
                stride: int = 1, dtype=torch.bfloat16) -> dict:
    """The ragged route's plan (any C_in, C_out and stride, every form):
    ``cb`` output channels per CTA (the smallest of 16, 32, 64 that holds
    C_out, else 128 with the last block cut). The resident kernel takes
    the shape when its layout fits in 227 KB (:func:`ragged_resident_bytes`)
    with ``wgs`` 2 warpgroups a CTA of ``ring`` 2 x stages each, else 1;
    else one warpgroup of 2, else 1 stages: ``stages`` = ``k`` taps, ``kw``
    their contraction bytes. Else the staged kernel (``wgs`` and ``ring``
    0): ``stages`` the weight taps staged at once (all k when they
    fit in 112 KB, for two CTAs per SM, or in the 227 KB limit when one tap
    alone does not fit in 112 KB; else as many as fit), ``kw`` one stage's
    contraction bytes and ``smem`` (:func:`ragged_plan_bytes`), or
    ValueError when not even one tap fits."""
    cb = next((cb for cb in (16, 32, 64) if c_out <= cb), 128)
    for wgs, ring in ((2, 2), (2, 1), (1, 2), (1, 1)):
        kp, smem = ragged_resident_bytes(c_in, k, dilation, cb, ring, stride,
                                         _ESIZE[dtype], wgs)
        if smem <= SMEM_LIMIT:
            return dict(route="ragged", cb=cb, kw=kp, stages=k, wgs=wgs,
                        ring=ring, smem=smem)
    kp, smem = ragged_plan_bytes(c_in, k, dilation, cb, 1, stride)
    if smem > SMEM_LIMIT:
        raise ValueError(f"C_in={c_in}, k={k}, dilation={dilation}, "
                         f"stride={stride}: the "
                         f"ragged route's tile and one weight tap need "
                         f"{smem} B of shared memory, over {SMEM_LIMIT}")
    budget = _MMA_TARGET if smem <= _MMA_TARGET else SMEM_LIMIT
    taps = 1
    while taps < k:
        more = ragged_plan_bytes(c_in, k, dilation, cb, taps + 1, stride)
        if more[1] > budget:
            break
        taps += 1
        kp, smem = more
    return dict(route="ragged", cb=cb, kw=kp, stages=taps, wgs=0, ring=0,
                smem=smem)


def wgmma_plan_bytes(c_in: int, k: int, dilation: int, cb: int, kw: int,
                     stages: int, dtype) -> int:
    """Shared memory of the wgmma route's layout: the resident weights
    (``k * C_in * cb`` bytes), the ring of x stages (chunks of ``64 +
    d(k-1)`` rows by ``kw`` int8 or ``min(kw, 64)`` bf16 channels, each
    1 KB aligned), the dequant form's three s8 tiles (``kw``-byte chunks)
    and its mbarriers, two output buffers of 64 rows x ``cb`` elements,
    5 x ``cb`` f32 parameters, the ring's 2 x ``stages`` mbarriers and
    1 KB of alignment slack."""
    esize = _ESIZE[dtype]
    rows = _TL + dilation * (k - 1)
    xw = kw if esize == 1 else min(kw, 64)
    stage = c_in // xw * _align(rows * xw * esize)
    # the dequant form's s8 tiles, their full / empty mbarriers and one
    # residual mbarrier per consumer warpgroup
    a_tiles = 0 if esize == 1 else (_QSLOTS * ((c_in // kw)
                                               * _align(rows * kw) + 16)
                                    + 16)
    return (_align(k * c_in * cb) + stages * stage + a_tiles
            + 2 * _TL * cb * esize + 20 * cb + 16 * stages + 1024)


def mma_plan_bytes(c_in: int, k: int, dilation: int, cb: int) -> int:
    """Shared memory of the mma route: the tile of 128 + d(k-1) rows of
    C_in + 16 bytes and as many weight taps of ``cb`` such rows as fit (in
    112 KB when one tap fits there, for two CTAs per SM), or ValueError."""
    ld = c_in + _MMA_PAD
    xs = _align((_MMA_TL + dilation * (k - 1)) * ld, 16)
    tap = cb * ld
    if xs + tap > SMEM_LIMIT:
        raise ValueError(f"C_in={c_in}, k={k}, dilation={dilation}: the "
                         f"input tile and one weight tap need {xs + tap} B "
                         f"of shared memory, over {SMEM_LIMIT}")
    budget = _MMA_TARGET if xs + tap <= _MMA_TARGET else SMEM_LIMIT
    return xs + min((budget - xs) // tap, k) * tap


#: the C entry's arguments: in_dtype, 10 pointers, n_rows, L, L_out, C_in,
#: C_out, k, dilation, stride, pad_l, act, route, cb, kw, stages, smem
#: bytes, SM count, stream
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 16
            + [ctypes.c_void_p])
_ROUTES = {"mma": 0, "wgmma": 1, "ragged": 2}


@functools.cache
def _lib():
    from jaeger_tpu_torch.ops import cuda_build

    lib = cuda_build.load("int8_conv")
    fn = lib.jt_int8_conv
    # every pointer and the stream as c_void_p: ctypes would pass a
    # Python int as a 32-bit C int
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def _launch(x, w, scale, inv_act, bias, dyt, in_mask, out_mask, residual,
            out, dilation, stride, pad_l, act, plan):
    """Launch the kernel on checked, contiguous CUDA tensors with ``plan``
    (:func:`int8_plan`'s dict)."""
    global launches

    def ptr(t):
        return None if t is None else t.data_ptr()

    n, length, c_in = x.shape
    k, _, c_out = w.shape
    dtype_id = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    err = _lib()(dtype_id, ptr(x), ptr(w), ptr(scale), ptr(inv_act),
                 ptr(bias), ptr(dyt), ptr(in_mask), ptr(out_mask),
                 ptr(residual), ptr(out), n, length, out.shape[1], c_in,
                 c_out, k, dilation, stride, pad_l, _ACT_IDS[act],
                 _ROUTES[plan["route"]], plan["cb"], plan["kw"],
                 plan["stages"], plan["smem"], sms, stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {err}")
    launches += 1
    route_launches[plan["route"]] += 1
    return out


def _check_conv(name, x, w, x_dtypes, dilation, padding, stride=1):
    """x and w checked and contiguous, and the launch plan."""
    if x.dtype not in x_dtypes:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: x must be (N, L, C_in) and w "
                         f"(k, C_in, C_out), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.dtype != torch.int8:
        raise ValueError(f"{name}: w must be int8, got {w.dtype}")
    k, c_in, c_out = w.shape
    if x.shape[2] != c_in:
        raise ValueError(f"{name}: x has {x.shape[2]} channels, w {c_in}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    plan = int8_plan(c_in, c_out, k, dilation, padding, x.dtype, stride)
    # the ragged route takes any alignment of x and w (its loads adapt to
    # it); TMA and the 16-byte loads of the other routes need 16-byte rows
    align = 1 if plan["route"] == "ragged" else 16
    dev = x.device
    return (_check("x", x, x.shape, x.dtype, dev, align),
            _check("w", w, w.shape, torch.int8, dev, align), plan)


def int8_conv_requant(x, w, scale, dilation: int = 1, stride: int = 1):
    """SAME int8 conv with the requant epilogue (at stride 1 the Pallas
    kernel's function). ``scale``: a float or a 1-element f32 tensor."""
    if x.device.type == "cpu":
        return reference_int8_conv_requant(x, w, scale, dilation, stride)
    x, w, plan = _check_conv("int8_conv_requant", x, w, (torch.int8,),
                             dilation, "same", stride)
    k, _, c_out = w.shape
    l_out, pad_l, _ = conv_geometry(x.shape[1], k, dilation, "SAME", stride)
    out = torch.empty(x.shape[0], l_out, c_out, dtype=torch.int8,
                      device=x.device)
    return _launch(x, w, _f32(scale, x.device, "scale"), None, None, None,
                   None, None, None, out, dilation, stride, pad_l, "none",
                   plan)


def int8_conv_dequant(x, w, inv_act, dq, bias=None, dyt=None, act="none",
                      use_dyt=False, *, dilation=1, padding="same", stride=1,
                      bias_then_dyt=False, in_mask=None, out_mask=None,
                      residual=None):
    """Int8 conv of a float activation, quantized on load and dequantized
    per channel, with fused_conv_block's epilogue (a stride above 1 takes
    the ragged route).

    ``inv_act``: ``f32(1 / act_scale)`` as a float or 1-element tensor;
    ``dq`` ``(C_out,)`` f32; ``bias`` ``(C_out,)``; ``dyt`` ``(3, C_out)``;
    ``in_mask`` ``(N, L)``; ``out_mask`` ``(N, L_out)``; ``residual``
    ``(N, L_out, C_out)``.
    """
    if x.device.type == "cpu":
        return reference_int8_conv_dequant(
            x, w, inv_act, dq, bias, dyt, act, use_dyt, dilation=dilation,
            padding=padding, stride=stride, bias_then_dyt=bias_then_dyt,
            in_mask=in_mask, out_mask=out_mask, residual=residual)
    x, w, plan = _check_conv("int8_conv_dequant", x, w,
                             (torch.float32, torch.bfloat16), dilation,
                             padding, stride)
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported activation {act!r}")
    bias, dyt = _epilogue_args(bias, dyt, use_dyt, bias_then_dyt)
    n, length, _ = x.shape
    k, _, c_out = w.shape
    l_out, pad_l, _ = conv_geometry(length, k, dilation, padding, stride)
    dev = x.device
    f32 = torch.float32
    dq = _check("dq", dq, (c_out,), f32, dev, align=4)
    bias = _check("bias", bias, (c_out,), f32, dev, align=4)
    dyt = _check("dyt", dyt, (3, c_out), f32, dev, align=4)
    in_mask = _check("in_mask", in_mask, (n, length), torch.bool, dev, 1)
    out_mask = _check("out_mask", out_mask, (n, l_out), torch.bool, dev, 1)
    residual = _check("residual", residual, (n, l_out, c_out), x.dtype, dev)
    out = torch.empty(n, l_out, c_out, dtype=x.dtype, device=dev)
    return _launch(x, w, dq, _f32(inv_act, dev, "inv_act"), bias, dyt,
                   in_mask, out_mask, residual, out, dilation, stride, pad_l,
                   act, plan)
