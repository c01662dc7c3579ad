"""Gradient of the fused conv block: the residual convs' backward.

The Pallas kernel ``jaeger_tpu/ops/pallas_conv.py::fused_conv_block`` has
no VJP: JAX trains its convs through XLA. The port runs every fusable
residual conv of a training forward on the ``fused_conv_block`` kernel
(:mod:`jaeger_tpu_torch.ops.fused_conv`), so :class:`FusedConvBlockFn`
gives that kernel a backward on hand-written kernels. The forward is

    u = conv_SAME(x * m_in, W) (+ b)       s = o * (g * tanh(a * u) + be) + r
    y = act(s)

(DYT form; the bias-only form is ``y = u``), and with ``t = tanh(a * u)``,
``ds = dy * act'(s)``::

    dr = ds        dbe = sum o * ds        dg = sum o * ds * t
    du = o * ds * g * a * (1 - t^2)        da = sum o * ds * g * u * (1 - t^2)
    db = sum du    dx = m_in * conv_SAME(du, W')   W'[j] = W[k - 1 - j]^T
    dW[j] = sum_rows (x * m_in)[row + j - pad]^T du[row]

On CUDA tensors the backward runs three kernels:

* ``conv_epilogue_bwd`` (CUDA C++, ``csrc/conv_epilogue_bwd.cu``,
  :func:`conv_epilogue_bwd`): one pass over ``dy``, ``u``, ``r`` and the
  out mask writing ``du`` and ``dr`` and per-CTA partials of ``da``,
  ``dg``, ``dbe``, summed in a fixed order; persistent CTAs fed by 1-D
  bulk copies into an mbarrier ring (:func:`epilogue_plan`). At the train
  shape (N = 1536, L = 500, C = 128, bf16) the conv2 form moves 983 MB
  (0.29 ms at 3.35 TB/s); it is memory-bound.
* ``conv_wgrad`` (CUDA C++, ``csrc/fused_conv_wgrad.cu``,
  :func:`conv_wgrad`): ``dW`` and ``db``; bf16 is a persistent ``wgmma``
  kernel fed by TMA, each CTA holding a 64-ci block of dW for all taps in
  registers over a contiguous share of the row tiles
  (:func:`wgrad_plan`); partials summed in a second fixed-order pass (no
  float atomics: the same bits run to run).
* the data gradient: no new kernel. For odd k the transposed SAME conv is
  a SAME conv with the flipped, transposed weights, so ``dx`` is one more
  launch of ``fused_conv_block`` (act none, no bias, ``out_mask = m_in``).
  Even k raises ``NotImplementedError`` before any launch.

``u`` (the DYT input, ``acc + b`` in x's dtype) is recomputed in the
backward by a bias-only launch of the same forward kernel rather than
written by the training forward: the inference kernel and its C entry stay
exactly as they are, and the step keeps one activation-size tensor less
per conv alive between forward and backward, for the cost of one bias-only
conv per DYT conv. The bias-only form needs no epilogue kernel (``du =
dy``).

CPU tensors take :func:`reference_conv_block_backward`, the plain version
(explicit formulas in f32, not autograd). ``launches`` counts each
kernel's launches by name.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from jaeger_tpu_torch.ops import fused_conv
from jaeger_tpu_torch.ops.fused_conv import (_ACT_IDS, _check,
                                             _epilogue_args,
                                             reference_conv_block)

#: kernel launches since the last reset, by kernel (set each to 0 to reset)
launches = {"conv_wgrad": 0, "conv_epilogue_bwd": 0}

_EVEN_K = ("a fused conv with an even kernel_size has no SAME-conv data "
           "gradient on the fused kernel; even-k fused gradients are not "
           "yet ported to jaeger_tpu_torch (ROADMAP.md queue 2, item 7)")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _act_grad(s: torch.Tensor, act: str | None) -> torch.Tensor:
    """d act(s) / ds in f32."""
    if act in (None, "none", "linear"):
        return torch.ones_like(s)
    if act == "relu":
        return (s > 0).to(s.dtype)
    if act == "tanh":
        return 1.0 - torch.tanh(s) ** 2
    if act in ("gelu", "gelu_exact"):
        cdf = 0.5 * (1.0 + torch.erf(s * (1.0 / math.sqrt(2.0))))
        pdf = torch.exp(-0.5 * s * s) / math.sqrt(2.0 * math.pi)
        return cdf + s * pdf
    if act == "gelu_tanh":
        c = math.sqrt(2.0 / math.pi)
        z = torch.tanh(c * (s + 0.044715 * s ** 3))
        return 0.5 * (1.0 + z) + 0.5 * s * (1.0 - z * z) * c * (
            1.0 + 3 * 0.044715 * s * s)
    raise ValueError(f"unsupported activation {act!r}")


def reference_conv_epilogue_bwd(dy, u, residual=None, out_mask=None, dyt=None,
                                act="none"):
    """Plain version of :func:`conv_epilogue_bwd`: ``(du, dr, ddyt)`` with
    ``du`` and ``dr`` in ``dy``'s dtype and ``ddyt`` the (3, C) f32 rows
    (da, dg, dbe; None without DYT)."""
    c = u.shape[-1]
    uf = u.float().reshape(-1, c)
    o = (torch.ones(uf.shape[0], 1, device=u.device) if out_mask is None
         else out_mask.reshape(-1, 1).float())
    if dyt is not None:
        d = dyt.float()
        t = torch.tanh(d[0] * uf)
        y = d[1] * t + d[2]
    else:
        y = uf
    s = o * y
    if residual is not None:
        s = s + residual.float().reshape(-1, c)
    ds = dy.float().reshape(-1, c) * _act_grad(s, act)
    ods = o * ds
    ddyt = None
    if dyt is not None:
        g = ods * d[1] * (1.0 - t * t)
        du = g * d[0]
        ddyt = torch.stack([(g * uf).sum(0), (ods * t).sum(0), ods.sum(0)])
    else:
        du = ods
    return (du.to(dy.dtype).reshape(dy.shape), ds.to(dy.dtype).reshape(dy.shape),
            ddyt)


def flipped_weights(w: torch.Tensor) -> torch.Tensor:
    """``W'[j] = W[k - 1 - j]^T``: the SAME conv that is the transpose of a
    SAME conv with ``w`` for odd k."""
    return w.flip(0).transpose(1, 2).contiguous()


def reference_conv_wgrad(x, du, in_mask=None, k=5):
    """Plain version of :func:`conv_wgrad`: ``(dW (k, C, C), db (C,))`` in
    f32 from x and du in their dtype."""
    n, length, c = x.shape
    pad_l = (k - 1) // 2
    if in_mask is not None:
        x = torch.where(in_mask[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    xf = F.pad(x.float(), (0, 0, pad_l, k - 1 - pad_l))
    duf = du.float().reshape(-1, c)
    dw = torch.stack([xf[:, j:j + length].reshape(-1, c).T @ duf
                      for j in range(k)])
    return dw, duf.sum(0)


def reference_conv_block_backward(dy, x, w, bias=None, dyt=None, act="none",
                                  *, bias_then_dyt=False, in_mask=None,
                                  out_mask=None, residual=None):
    """Plain version of the fused conv block's backward (explicit formulas
    in f32): ``(dx, dw, dbias, ddyt, dresidual)`` for
    :func:`jaeger_tpu_torch.ops.fused_conv.fused_conv_block`'s arguments;
    ``dx`` and ``dresidual`` in x's dtype, the others in f32 (None where
    the input is None). ``du`` is rounded to x's dtype before the two
    convs, as the kernels keep it."""
    k = w.shape[0]
    if k % 2 == 0:
        raise NotImplementedError(_EVEN_K)
    b_used, _ = _epilogue_args(bias, dyt, dyt is not None, bias_then_dyt)
    u = reference_conv_block(x, w, b_used, in_mask=in_mask)
    du, dr, ddyt = reference_conv_epilogue_bwd(
        dy.float(), u.float(), residual, out_mask, dyt, act)
    du = du.to(x.dtype)
    dw, db = reference_conv_wgrad(x, du, in_mask, k)
    dx = reference_conv_block(du, flipped_weights(w.float()),
                              out_mask=in_mask)
    dbias = None
    if bias is not None:
        dbias = db if b_used is not None else torch.zeros_like(db)
    return (dx.to(x.dtype), dw, dbias, ddyt,
            None if residual is None else dr.to(x.dtype))


# ---------------------------------------------------------------------------
# conv_wgrad (CUDA C++)
# ---------------------------------------------------------------------------

#: the C entry's arguments: dtype, 7 pointers, n_rows, L, C, K, groups,
#: co_block, stages, smem bytes, stream
WGRAD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])
#: tap counts the bf16 kernel is instantiated for, and its ci block (the
#: wgmma M; the fusable convs of ``train_config/*.yaml``: k 3 or 5, C 64 or
#: 128)
WGRAD_TAPS = (3, 5)
WGRAD_CB = 64
#: rows per tile of the bf16 kernel and its ring stages
_WGRAD_TL = 64
_WGRAD_STAGES = 4


@functools.cache
def _wgrad_lib():
    from jaeger_tpu_torch.ops import cuda_build

    fn = cuda_build.load("fused_conv_wgrad").jt_conv_wgrad
    fn.restype = ctypes.c_int
    fn.argtypes = WGRAD_ARGTYPES
    return fn


def check_wgrad_shape(c: int, k: int, dtype) -> None:
    """ValueError unless :func:`conv_wgrad` takes C channels and k taps
    in ``dtype``: odd k and C % 16 == 0 in f32; k in ``WGRAD_TAPS`` and C
    a multiple of ``WGRAD_CB`` in bf16."""
    if c <= 0 or c % 16:
        raise ValueError(f"C={c}: conv_wgrad takes C % 16 == 0")
    if k % 2 == 0:
        raise ValueError(f"k={k}: conv_wgrad takes odd k")
    if dtype != torch.float32 and (k not in WGRAD_TAPS or c % WGRAD_CB):
        raise ValueError(
            f"C={c}, k={k}: the bf16 conv_wgrad takes k in {WGRAD_TAPS} and "
            f"C a multiple of {WGRAD_CB}; other bf16 shapes are not yet "
            f"ported to jaeger_tpu_torch (ROADMAP.md queue 2)")


def _align1k(v: int) -> int:
    return -(-v // 1024) * 1024


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def wgrad_plan(n: int, length: int, c: int, k: int, dtype, sms: int,
               stages: int = _WGRAD_STAGES) -> dict:
    """The launch plan of :func:`conv_wgrad`, or ValueError.

    bf16 (``route`` "wgmma"): ``co_block`` (128 where it divides C, else
    64), ``group`` CTAs per tile share (C / 64 ci blocks x C / co_block co
    blocks, neighbours in the grid walking the same tiles), ``groups``
    contiguous tile shares (one per partial slot: at most one CTA per SM in
    all, at most one share per 64-row tile), ``ctas`` = groups x group,
    ``stages`` of the TMA ring and ``smem`` bytes (stages x (x halo box,
    1 KB aligned, + two du boxes) +
    3 x stages mbarriers + 1 KB slack), which the C entry recomputes and
    must equal; ``cluster`` False (the group's
    CTAs share the du tile through L2, not by multicast). f32 (``route``
    "fma"): ``groups`` row splits, four per SM. Cached: do not modify the
    dict."""
    check_wgrad_shape(c, k, dtype)
    if dtype == torch.float32:
        groups = max(1, min(4 * sms, n * length))
        return dict(route="fma", groups=groups, group=1, ctas=groups,
                    co_block=0, stages=0, smem=0, cluster=False)
    co_block = 128 if c % 128 == 0 else 64
    group = (c // WGRAD_CB) * (c // co_block)
    tiles = n * -(-length // _WGRAD_TL)
    groups = max(1, min(tiles, sms // group))
    rows = _WGRAD_TL + k - 1
    box = _WGRAD_TL * co_block
    stage = _align1k(rows * WGRAD_CB * 2) + 2 * box
    smem = stages * stage + 24 * stages + 1024
    return dict(route="wgmma", groups=groups, group=group,
                ctas=groups * group, co_block=co_block, stages=stages,
                smem=smem, cluster=False)


def wgrad_shares(n: int, length: int, groups: int) -> list[range]:
    """The 64-row tiles (index ``n * ceil(L / 64) + l0 / 64``) of each tile
    share of the bf16 kernel, in the order its CTAs walk them: share ``p``
    is ``[T p / groups, T (p + 1) / groups)`` of the ``T`` tiles (the
    kernel's formula). The partial of share ``p`` is added ``p``-th."""
    tiles = n * -(-length // _WGRAD_TL)
    return [range(tiles * p // groups, tiles * (p + 1) // groups)
            for p in range(groups)]


def conv_wgrad(x, du, in_mask=None, k=5, *, plan=None):
    """``(dW, db)`` of a SAME conv with input ``x`` (N, L, C) (rows where
    ``in_mask`` is false read as zero) and output gradient ``du`` (N, L,
    C), both bf16 or f32: dW (k, C, C) and db (C,) in f32. ``plan``
    (another :func:`wgrad_plan`, for measurements) replaces the default
    one; the C entry refuses one that does not fit the shape."""
    if x.device.type == "cpu":
        return reference_conv_wgrad(x, du, in_mask, k)
    if x.device.type != "cuda":
        raise ValueError(f"conv_wgrad: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_wgrad: unsupported dtype {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (N, L, C), got {tuple(x.shape)}")
    n, length, c = x.shape
    dev = x.device
    if plan is None:
        plan = wgrad_plan(n, length, c, k, x.dtype, _sm_count(dev.index))
    x = _check("x", x, (n, length, c), x.dtype, dev)
    du = _check("du", du, (n, length, c), x.dtype, dev)
    in_mask = _check("in_mask", in_mask, (n, length), torch.bool, dev, 1)
    g = plan["groups"]
    part_w = torch.empty(g, k, c, c, dtype=torch.float32, device=dev)
    part_b = torch.empty(g, c, dtype=torch.float32, device=dev)
    dw = torch.empty(k, c, c, dtype=torch.float32, device=dev)
    db = torch.empty(c, dtype=torch.float32, device=dev)
    err = _wgrad_lib()(
        1 if x.dtype == torch.bfloat16 else 0, x.data_ptr(), du.data_ptr(),
        None if in_mask is None else in_mask.data_ptr(), part_w.data_ptr(),
        part_b.data_ptr(), dw.data_ptr(), db.data_ptr(), n, length, c, k, g,
        plan["co_block"], plan["stages"], plan["smem"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_wgrad kernel launch failed: CUDA error {err}")
    launches["conv_wgrad"] += 1
    return dw, db


# ---------------------------------------------------------------------------
# conv_epilogue_bwd (CUDA C++)
# ---------------------------------------------------------------------------

#: the C entry's arguments: dtype, 9 pointers, rows, C, act, rows per
#: chunk, stages, CTAs, smem bytes, stream
EPILOGUE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
#: consumer threads per CTA, bytes of one chunk at most, ring stages
_EPI_CONSUMERS = 256
_EPI_CHUNK_BYTES = 8192
_EPI_STAGES = 4


@functools.cache
def _epilogue_lib():
    from jaeger_tpu_torch.ops import cuda_build

    fn = cuda_build.load("conv_epilogue_bwd").jt_conv_epilogue_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = EPILOGUE_ARGTYPES
    return fn


@functools.lru_cache(maxsize=256)
def epilogue_plan(rows: int, c: int, dtype, residual: bool, sms: int) -> dict:
    """The launch plan of :func:`conv_epilogue_bwd` over ``rows`` = N * L
    rows of C channels, or ValueError (C % 16 == 0 and C <= 1024: a thread
    owns 4 channels, a row at most 256 threads).

    ``rows_per_chunk`` R: the largest power of two <= 64 with R rows <= 8 KB;
    ``chunks``: ceil(rows / R); ``ctas``: about two per SM, at most one per
    chunk, CTA ``b`` taking chunks ``[chunks b / ctas, chunks (b + 1) /
    ctas)``; ``stages`` 4 of dy, u (and the residual) chunks; ``smem`` the
    ring and its mbarriers, or the row groups' partial sums where those are
    larger, which the C entry recomputes and must equal. Cached: do not
    modify the dict."""
    esize = 4 if dtype == torch.float32 else 2
    row_bytes = c * esize
    if rows <= 0 or c <= 0 or c % 16 or c // 4 > _EPI_CONSUMERS:
        raise ValueError(f"rows={rows}, C={c}: conv_epilogue_bwd takes C % 16 "
                         f"== 0 and C <= {4 * _EPI_CONSUMERS}")
    r = 64
    while r > 1 and r * row_bytes > _EPI_CHUNK_BYTES:
        r //= 2
    chunks = -(-rows // r)
    ntens = 3 if residual else 2
    red = 3 * (_EPI_CONSUMERS // (c // 4)) * c * 4
    smem = max(_EPI_STAGES * ntens * r * row_bytes + 16 * _EPI_STAGES, red)
    return dict(rows_per_chunk=r, chunks=chunks,
                ctas=max(1, min(2 * sms, chunks)), stages=_EPI_STAGES,
                smem=smem)


def epilogue_shares(rows: int, plan: dict) -> list[range]:
    """The rows of each CTA of :func:`conv_epilogue_bwd` in the order it
    walks them (the kernel's formula); CTA ``b``'s partial sums are added
    ``b``-th."""
    r, chunks, ctas = plan["rows_per_chunk"], plan["chunks"], plan["ctas"]
    return [range(chunks * b // ctas * r,
                  min(rows, chunks * (b + 1) // ctas * r))
            for b in range(ctas)]


def conv_epilogue_bwd(dy, u, residual=None, out_mask=None, dyt=None,
                      act="none"):
    """The epilogue's backward from ``dy`` (N, L, C), the DYT input ``u``
    (N, L, C), the residual and out mask of the forward: ``(du, dr,
    ddyt)``, ``du`` and ``dr`` (None without residual) in dy's dtype,
    ``ddyt`` the (3, C) f32 gradient rows of alpha, gamma and beta (None
    without DYT). On CUDA one pass of the kernel writes du and dr and
    per-CTA partials of ddyt, summed in CTA order in the same C entry."""
    if dy.device.type == "cpu":
        du, dr, ddyt = reference_conv_epilogue_bwd(dy, u, residual, out_mask,
                                                   dyt, act)
        return du, (dr if residual is not None else None), ddyt
    if dy.device.type != "cuda":
        raise ValueError(f"conv_epilogue_bwd: unsupported device {dy.device}")
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_epilogue_bwd: unsupported dtype {dy.dtype}")
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported activation {act!r}")
    n, length, c = dy.shape
    dev = dy.device
    rows = n * length
    plan = epilogue_plan(rows, c, dy.dtype, residual is not None,
                         _sm_count(dev.index))
    dy = _check("dy", dy, (n, length, c), dy.dtype, dev)
    u = _check("u", u, (n, length, c), dy.dtype, dev)
    residual = _check("residual", residual, (n, length, c), dy.dtype, dev)
    out_mask = _check("out_mask", out_mask, (n, length), torch.bool, dev, 1)
    dyt = _check("dyt", dyt, (3, c), torch.float32, dev, align=4)
    du = torch.empty_like(dy)
    dr = torch.empty_like(dy) if residual is not None else None
    part = ddyt = None
    if dyt is not None:
        part = torch.empty(plan["ctas"], 3, c, dtype=torch.float32,
                           device=dev)
        ddyt = torch.empty(3, c, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _epilogue_lib()(
        1 if dy.dtype == torch.bfloat16 else 0, ptr(dy), ptr(u),
        ptr(residual), ptr(out_mask), ptr(dyt), ptr(du), ptr(dr), ptr(part),
        ptr(ddyt), rows, c, _ACT_IDS[act], plan["rows_per_chunk"],
        plan["stages"], plan["ctas"], plan["smem"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue_bwd kernel launch failed: CUDA "
                           f"error {err}")
    launches["conv_epilogue_bwd"] += 1
    return du, dr, ddyt


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------


def conv_block_backward(dy, x, w, bias=None, dyt=None, act="none", *,
                        bias_then_dyt=False, in_mask=None, out_mask=None,
                        residual=None):
    """The fused conv block's backward: ``(dx, dw, dbias, ddyt,
    dresidual)`` as :func:`reference_conv_block_backward`. CPU tensors take
    that plain version; CUDA tensors run the kernels (module docstring)."""
    if x.device.type == "cpu":
        return reference_conv_block_backward(
            dy, x, w, bias, dyt, act, bias_then_dyt=bias_then_dyt,
            in_mask=in_mask, out_mask=out_mask, residual=residual)
    k = w.shape[0]
    if k % 2 == 0:
        raise NotImplementedError(_EVEN_K)
    use_dyt = dyt is not None
    b_used, _ = _epilogue_args(bias, dyt, use_dyt, bias_then_dyt)
    wc = w.to(x.dtype)
    dy = dy.to(x.dtype).contiguous()
    plain = (not use_dyt and out_mask is None and residual is None
             and act in (None, "none", "linear"))
    if plain:
        du, dr, ddyt = dy, None, None
    else:
        u = fused_conv.fused_conv_block(x, wc, b_used, in_mask=in_mask)
        du, dr, ddyt = conv_epilogue_bwd(dy, u, residual, out_mask, dyt, act)
    dx = fused_conv.fused_conv_block(du, flipped_weights(wc),
                                     out_mask=in_mask)
    dw, db = conv_wgrad(x, du, in_mask, k)
    dbias = None
    if bias is not None:
        dbias = db if b_used is not None else torch.zeros_like(db)
    return dx, dw, dbias, ddyt, dr


class FusedConvBlockFn(torch.autograd.Function):
    """``fused_conv_block`` with a backward (module docstring).

    ``apply(x, w, bias, dyt, residual, in_mask, out_mask, act,
    bias_then_dyt)``: x (N, L, C) and residual in the compute dtype; the f32
    parameters w (k, C, C), bias (C,) and dyt (3, C) (alpha, gamma, beta
    rows) are cast to the compute dtype inside, so their gradients stay
    f32. dyt None is the bias-only form.
    """

    @staticmethod
    def forward(ctx, x, w, bias, dyt, residual, in_mask, out_mask, act,
                bias_then_dyt):
        if w.shape[0] % 2 == 0:
            raise NotImplementedError(_EVEN_K)
        if x.device.type == "cuda":
            check_wgrad_shape(x.shape[-1], w.shape[0], x.dtype)
        ctx.act = act
        ctx.bias_then_dyt = bias_then_dyt
        ctx.save_for_backward(x, w, bias, dyt, residual, in_mask, out_mask)
        return fused_conv.fused_conv_block(
            x, w.to(x.dtype), bias, dyt, act, use_dyt=dyt is not None,
            bias_then_dyt=bias_then_dyt, in_mask=in_mask, out_mask=out_mask,
            residual=residual)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, dyt, residual, in_mask, out_mask = ctx.saved_tensors
        dx, dw, dbias, ddyt, dr = conv_block_backward(
            dy, x, w, bias, dyt, ctx.act, bias_then_dyt=ctx.bias_then_dyt,
            in_mask=in_mask, out_mask=out_mask, residual=residual)
        return dx, dw, dbias, ddyt, dr, None, None, None, None


def fused_conv_block_train(x, w, bias=None, dyt=None, act="none", *,
                           bias_then_dyt=False, in_mask=None, out_mask=None,
                           residual=None):
    """:class:`FusedConvBlockFn` with keyword arguments."""
    return FusedConvBlockFn.apply(x, w, bias, dyt, residual, in_mask,
                                  out_mask, act, bias_then_dyt)
