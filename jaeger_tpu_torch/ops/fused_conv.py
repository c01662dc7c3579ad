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
rate both allow about 1 ms. The kernel reads the activation once and
writes it once with the whole epilogue fused, and runs the k shifted
GEMMs on the tensor cores (WMMA, bf16 in, f32 accumulate) from a shared
memory tile that holds the input rows plus the k - 1 halo; weights stream
through shared memory tap by tap. f32 inputs use plain FMAs, never TF32.
wgmma, TMA and a persistent schedule are later work.

CPU tensors take :func:`reference_conv_block`, the plain PyTorch version;
CUDA tensors launch the kernel or raise. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: kernel launches since the last reset (set to 0 to reset)
launches = 0

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


@functools.cache
def _lib():
    from jaeger_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_conv_block")
    fn = lib.jt_fused_conv_block
    # every pointer and the stream as c_void_p: ctypes would pass a
    # Python int as a 32-bit C int
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
    global launches
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
    if c % 16 or (c > 128 and c % 128):
        raise ValueError(f"C={c}: the kernel takes C % 16 == 0 and "
                         f"C <= 128 or C % 128 == 0")
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
    out = torch.empty_like(x)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(1 if x.dtype == torch.bfloat16 else 0, ptr(x), ptr(w),
             ptr(bias), ptr(dyt), ptr(in_mask), ptr(out_mask), ptr(residual),
             ptr(out), n, length, c, k, _ACT_IDS[act], stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_block kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
