"""The masked layer zoo in PyTorch.

Counterpart of `jaeger_tpu/models/layers.py`. Layouts are the JAX
package's: activations ``(B, F, L, C)`` channels-last, masks ``(B, F, L)``
bool, and every layer returns ``(y, mask)``. Parameters keep the flax
names and shapes (conv kernels ``(k, C_in, C_out)``, dense kernels
``(in, out)``, attention projections ``(C, heads, head_dim)`` and
``(heads, head_dim, C)``) and are stored in f32; each layer casts them to
its compute dtype as the flax layers do. Ported: activations,
``apply_mask``, ``MaskedConv1D`` (with its int8 branch and calibration),
``MultiScaleConv1D``, ``MaskedBatchNorm``, ``MaskedLayerNorm``,
``LayerNorm``, ``MaskedDYT``, the poolers (``MaskedMaxPooling1D``, the
global max / average / last poolers, ``GatedFrameGlobalMaxPooling``),
``ResidualBlock`` and ``ResidualBlockStack``, ``NMDLayer``, ``NMDMerge``,
``OODSignalLayer``, the attention family (``MHA``, ``TransformerEncoder``,
``CrossFrameAttention``, ``AxialAttention``, ``LocalAttention``),
``MaskedBiLSTM``, the Hyena stack (``causal_fft_convolve`` with JAX's four
routes, ``HyenaFilter``, ``HyenaOperator``, ``HyenaBlock``), ``Dense``,
``OneHotEmbed``, ``SinusoidalPositionEmbedding``, ``sin_pe`` and
``dropout``.

Attention ports the function of JAX's ``_MHA``, not its TPU lowering:
plain matmuls, with the same cast points (for sequence axes of 16 or less
the scores and the weighted sum of values accumulate in f32 and round to
the compute dtype once), invalid keys filled with the compute dtype's
``finfo.min`` and the softmax in the compute dtype, so a row whose keys
are all invalid gets uniform weights, never NaN.

Train mode (``train=True``): ``MaskedBatchNorm`` uses batch statistics
(the masked two-pass variance, or ``E[x^2] - mean^2`` without a mask) and
updates its moving mean and variance with its momentum; ``NMDLayer``
measures against the batch mean and updates its moving mean; dropout
draws its keep mask from a ``torch.Generator``; fusable residual convs run
through :class:`jaeger_tpu_torch.ops.fused_conv_grad.FusedConvBlockFn`
(the fused kernel forward, hand-written backward kernels); everything else
trains by autograd. ``bn_stats_all_true`` keeps a masked batch norm whose
mask the bounded program dropped on the masked statistics under an
all-true mask, so the bounded program's statistics and gradients are the
masked program's (``jaeger_tpu/models/layers.py:736-790``).

int8 execution: a conv given ``kernel_q`` / ``w_scale`` / ``act_scale``
buffers (a full_int8 bundle's ``quant`` collection, ``set_quant``) runs on
:func:`jaeger_tpu_torch.ops.int8_conv.int8_conv_dequant`, inside a
residual block with the same fused epilogue as the float kernel;
:func:`calibrating` records each conv input's absmax for ``utils quantize
--mode full_int8``.

The JAX layers may defer a DYT norm's trailing re-zero when the builder
proves it output-exact (``defer_mask``); the port always re-zeroes, which
gives the same outputs.

``ResidualBlock`` runs every SAME, stride-1, dilation-1, C_in == C_out
conv whose shape the kernel's launch plan takes
(:meth:`MaskedConv1D.fused`) through
:func:`jaeger_tpu_torch.ops.fused_conv.fused_conv_block` (the Hopper
kernel on CUDA, its plain version on the CPU); with DYT norms the norm,
its re-zero, the shortcut add and the activation ride the kernel's
epilogue. Every other conv runs cuDNN's ``F.conv1d`` with the torch
epilogue, on every device alike.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from jaeger_tpu_torch.ops.fused_conv import conv_plan, fused_conv_block
from jaeger_tpu_torch.ops.fused_conv_grad import (check_wgrad_shape,
                                                  fused_conv_block_train)
from jaeger_tpu_torch.ops.int8_conv import conv_geometry, int8_conv_dequant
from jaeger_tpu_torch.parallel import multihost as mh

# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: exact erf form in f32, tanh approximation in bf16 (as JAX)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


def get_activation(name: str | None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by Keras name (exact GELU in f32)."""
    if name is None or name == "linear":
        return lambda x: x
    table = {
        "gelu": _gelu,
        "gelu_exact": lambda x: F.gelu(x),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "sigmoid": torch.sigmoid,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "tanh": torch.tanh,
        "sin": torch.sin,
        "swish": F.silu,
        "silu": F.silu,
        "elu": F.elu,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


def kernel_activation(name: str | None, dtype: torch.dtype) -> str | None:
    """The fused kernel's name for a layer activation, or None when the
    kernel has no such epilogue."""
    name = name or "linear"
    if name == "gelu":
        return "gelu_tanh" if dtype == torch.bfloat16 else "gelu"
    if name in ("linear", "relu", "tanh", "gelu_tanh", "gelu_exact"):
        return name
    return None


def apply_mask(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Zero masked positions with a select that writes +0.0."""
    if mask is None:
        return x
    return torch.where(mask[..., None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _same_pads(length: int, kernel: int, stride: int,
               dilation: int) -> tuple[int, int]:
    """XLA's SAME padding: (low, high)."""
    span = dilation * (kernel - 1) + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + span - length, 0)
    return total // 2, total - total // 2


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


@functools.lru_cache(maxsize=None)
def _kernel_takes(c: int, k: int, dtype: torch.dtype, train: bool) -> bool:
    """Whether the fused kernel's plans take C channels and k taps in
    ``dtype`` (and, in training, its backward's): asked before any
    launch, never by catching a launch's error."""
    try:
        conv_plan(c, k, dtype)
        if train:
            check_wgrad_shape(c, k, dtype)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


class MaskedConv1D(nn.Module):
    """Masked 1-D convolution over the length axis of (B, F, L, C).

    The output mask is the count of valid inputs under each window,
    thresholded by ``mask_mode`` (any / majority / strict).
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: str = "valid",
                 dilation_rate: int = 1, activation: str | None = None,
                 use_bias: bool = True, use_masking: bool = True,
                 mask_mode: str = "any", dtype=torch.float32):
        super().__init__()
        if mask_mode not in ("any", "majority", "strict"):
            raise ValueError(f"invalid mask_mode {mask_mode!r}")
        self.in_channels = int(in_channels)
        self.filters = int(filters)
        self.kernel_size = int(kernel_size)
        self.strides = int(strides)
        self.padding = str(padding).upper()
        self.dilation_rate = int(dilation_rate)
        self.activation = activation
        self.use_masking = bool(use_masking)
        self.mask_mode = mask_mode
        self.dtype = dtype
        self.kernel = _param(self.kernel_size, self.in_channels, self.filters)
        self.bias = _param(self.filters) if use_bias else None
        # int8 execution (a full_int8 bundle's quant collection): absent
        # until set_quant, so float bundles' state dicts are unchanged
        self.register_buffer("kernel_q", None)
        self.register_buffer("w_scale", None)
        self.register_buffer("act_scale", None)
        #: calibration recorder (see :func:`calibrating`), or None
        self.calib: Callable[[torch.Tensor], None] | None = None

    @property
    def fusable(self) -> bool:
        """Whether this conv has the fused kernel's form (SAME, stride 1,
        dilation 1, C_in == C_out); :meth:`fused` also asks its plans."""
        return (self.padding == "SAME" and self.strides == 1
                and self.dilation_rate == 1
                and self.in_channels == self.filters)

    def fused(self, dtype: torch.dtype, train: bool) -> bool:
        """Whether a residual block runs this conv on the fused kernel: it
        has the kernel's form and the kernel's launch plan takes its shape
        (``conv_plan``; in training also ``check_wgrad_shape``, which
        takes odd k only). The answer is the same on every device, so the
        CPU runs the route the card runs; a refused conv takes the cuDNN
        conv and the torch epilogue, as dilated convs do."""
        return self.fusable and _kernel_takes(self.filters,
                                              self.kernel_size, dtype, train)

    @property
    def int8(self) -> bool:
        """Whether this conv runs on the int8 kernel (quant buffers set)."""
        return self.kernel_q is not None

    def set_quant(self, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                  act_scale: torch.Tensor) -> None:
        """Switch this conv to int8 execution: ``kernel_q`` ``(k, C_in,
        C_out)`` int8, per-channel ``w_scale`` ``(C_out,)`` and the
        calibrated per-tensor ``act_scale`` ``()``, both f32."""
        shape = (self.kernel_size, self.in_channels, self.filters)
        if tuple(kernel_q.shape) != shape:
            raise ValueError(f"kernel_q has shape {tuple(kernel_q.shape)}, "
                             f"expected {shape}")
        dev = self.kernel.device
        self.kernel_q = kernel_q.to(dev, torch.int8)
        self.w_scale = w_scale.to(dev, torch.float32).reshape(self.filters)
        self.act_scale = act_scale.to(dev, torch.float32).reshape(())

    def int8_args(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(inv_act, dq)`` as ``layers.py:248,259-262`` compute them:
        ``f32(1 / act_scale)`` and ``f32(w_scale) * f32(act_scale)``."""
        return 1.0 / self.act_scale, self.w_scale * self.act_scale

    def record_input(self, x: torch.Tensor, mask) -> None:
        """In calibration mode, fold the per-tensor absmax of this conv's
        input, masked and cast to the compute dtype as the JAX layer's
        ``conv_in``, into the recorder."""
        if self.calib is not None:
            masked = self.use_masking and mask is not None
            conv_in = (apply_mask(x, mask) if masked else x).to(self.dtype)
            self.calib(torch.amax(torch.abs(conv_in)).float())

    def output_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """Valid-count under each kernel window, thresholded."""
        mi = mask.to(torch.int32)
        k_span = self.dilation_rate * (self.kernel_size - 1) + 1
        if self.padding == "SAME":
            pad_l = (k_span - 1) // 2
            mi = F.pad(mi, (pad_l, k_span - 1 - pad_l))
        out_len = (mi.shape[2] - k_span) // self.strides + 1
        mc = sum(
            mi[..., j * self.dilation_rate:
               j * self.dilation_rate + (out_len - 1) * self.strides + 1:
               self.strides]
            for j in range(self.kernel_size)
        )
        if self.mask_mode == "any":
            return mc > 0
        if self.mask_mode == "majority":
            return mc >= (self.kernel_size + 1) // 2
        return mc == self.kernel_size

    def _conv(self, x3: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        """(N, L, C_in) x (k, C_in, C_out) -> (N, L_out, C_out)."""
        length = x3.shape[1]
        if self.padding == "SAME":
            pads = _same_pads(length, self.kernel_size, self.strides,
                              self.dilation_rate)
        else:
            pads = (0, 0)
        xin = F.pad(x3.transpose(1, 2), pads)
        y = F.conv1d(xin, kernel.permute(2, 1, 0), stride=self.strides,
                     dilation=self.dilation_rate)
        return y.transpose(1, 2)

    def forward(self, x, mask=None, fold_table=None):
        """``fold_table``: a ``(vocab, c)`` f32 embedding table. When given,
        ``x`` is raw token ids ``(B, F, L)`` and the linear embedding is
        folded into the kernel — ``conv(onehot(tok) @ T, K)`` becomes
        ``conv(onehot(tok), einsum(T, K))``; masked positions are token 0,
        so zeroing folded row 0 reproduces ``apply_mask``."""
        if fold_table is None:
            b, f, length, _ = x.shape
        else:
            b, f, length = x.shape
        masked = self.use_masking and mask is not None
        out_mask = self.output_mask(mask) if masked else None
        if fold_table is not None:
            vocab = fold_table.shape[0]
            folded = torch.einsum("ve,kef->kvf", fold_table.float(),
                                  self.kernel.float())
            if masked:
                folded[:, 0, :] = 0.0
            conv_in = F.one_hot(x.reshape(b * f, length).long(),
                                vocab).to(self.dtype)
            kernel = folded.to(self.dtype)
        elif self.int8:
            # layers.py:228-262: quantize with the calibrated scale, int8
            # conv, dequantize per channel, bias, activation; fused in the
            # int8 kernel, the masked pre-zero as its in_mask
            self.record_input(x, mask)
            k_act = kernel_activation(self.activation, self.dtype)
            inv_act, dq = self.int8_args()
            y = int8_conv_dequant(
                x.reshape(b * f, length, -1).to(self.dtype), self.kernel_q,
                inv_act, dq,
                None if self.bias is None
                else self.bias.to(self.dtype).float(),
                act=k_act or "none", dilation=self.dilation_rate,
                padding=self.padding, stride=self.strides,
                in_mask=mask.reshape(b * f, length) if masked else None)
            if k_act is None:
                y = get_activation(self.activation)(y)
            return y.reshape(b, f, y.shape[1], self.filters), out_mask
        else:
            self.record_input(x, mask)
            if masked:
                x = apply_mask(x, mask)
            conv_in = x.reshape(b * f, length, -1).to(self.dtype)
            kernel = self.kernel.to(self.dtype)
        y = self._conv(conv_in, kernel)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        y = get_activation(self.activation)(y)
        return y.reshape(b, f, y.shape[1], self.filters), out_mask


_MULTI_SCALE_KEYS = ("filters", "kernel_size", "strides", "padding",
                     "dilation_rate", "activation", "use_bias", "mask_mode")


class MultiScaleConv1D(nn.Module):
    """Parallel masked convs (``branch_<i>``) at several kernel sizes, all
    SAME and stride 1, concatenated or added; the output mask is the AND
    of the branches' masks."""

    def __init__(self, in_channels: int, branches, merge: str = "concat",
                 use_bias: bool = True, use_masking: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if merge not in ("concat", "add"):
            raise ValueError(f"merge must be concat/add, got {merge!r}")
        self.merge = merge
        self.n_branches = len(branches)
        widths = []
        for i, cfg in enumerate(branches):
            cfg = dict(cfg)
            cfg.setdefault("padding", "same")
            cfg.setdefault("strides", 1)
            cfg.setdefault("use_bias", use_bias)
            if cfg["padding"].lower() != "same" or cfg["strides"] != 1:
                raise ValueError("multi-scale branches require same/stride-1")
            conv = MaskedConv1D(
                in_channels, use_masking=use_masking, dtype=dtype,
                **{k: v for k, v in cfg.items() if k in _MULTI_SCALE_KEYS})
            self.add_module(f"branch_{i}", conv)
            widths.append(conv.filters)
        self.out_channels = sum(widths) if merge == "concat" else widths[0]

    def forward(self, x, mask=None):
        outs, masks = [], []
        for i in range(self.n_branches):
            y, m = getattr(self, f"branch_{i}")(x, mask)
            outs.append(y)
            masks.append(m)
        x = torch.cat(outs, dim=-1) if self.merge == "concat" else sum(outs)
        out_mask = None
        if masks and masks[0] is not None:
            out_mask = masks[0]
            for m in masks[1:]:
                out_mask = out_mask & m
        return x, out_mask


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """int8 calibration mode (the JAX layer's ``calib`` sow).

    Inside the block every ``MaskedConv1D`` of ``model`` that convolves an
    unfolded input records the per-tensor absmax of that input, masked and
    in the compute dtype, max-reduced over calls, into the yielded dict
    keyed by module name (device scalars). The recorders are removed on
    exit, so the model keeps no calibration state.
    """
    records: dict[str, torch.Tensor] = {}
    convs = [(name, m) for name, m in model.named_modules()
             if isinstance(m, MaskedConv1D)]

    def recorder(name: str):
        def record(v: torch.Tensor) -> None:
            old = records.get(name)
            records[name] = v if old is None else torch.maximum(old, v)
        return record

    for name, m in convs:
        m.calib = recorder(name)
    try:
        yield records
    finally:
        for _, m in convs:
            m.calib = None


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


class MaskedBatchNorm(nn.Module):
    """Mask-aware batch normalization with f32 statistics.

    Eval mode normalizes with the moving statistics; train mode with the
    batch's (masked positions excluded) and updates the moving ones. With
    ``return_nmd=True`` also returns the per-example channel mean minus the
    reference mean (the NMD vector), over valid positions only.
    """

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 return_nmd: bool = False, use_masking: bool = True,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.return_nmd = bool(return_nmd)
        self.use_masking = bool(use_masking)
        self.gamma = _param(channels)
        self.beta = _param(channels)
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))

    def _batch_stats(self, x, mask):
        """(mean, variance) over every axis but channels, in f32. Under a
        process group the statistics are the global batch's
        (:func:`~jaeger_tpu_torch.parallel.multihost.all_reduce_sum`: the
        masked sum and count, then the squared deviations; the dense sum
        and sum of squares), JAX's two formulas on the global batch."""
        reduce_axes = tuple(range(x.dim() - 1))
        if self.use_masking and mask is not None:
            mf = mask[..., None]
            total, count = mh.all_reduce_sum(
                torch.sum(apply_mask(x, mask), dim=reduce_axes,
                          dtype=torch.float32),
                torch.sum(mf, dim=reduce_axes, dtype=torch.float32))
            valid = count + self.epsilon
            mean = total / valid
            sq = torch.square(x.float() - mean) * mf.float()
            return mean, mh.all_reduce_sum(
                torch.sum(sq, dim=reduce_axes)) / valid
        n = math.prod(x.shape[a] for a in reduce_axes) * mh.process_count()
        total, squares = mh.all_reduce_sum(
            torch.sum(x, dim=reduce_axes, dtype=torch.float32),
            torch.sum(torch.square(x.float()), dim=reduce_axes))
        mean = total / n
        return mean, squares / n - torch.square(mean)

    def forward(self, x, mask=None, train: bool = False):
        if train:
            mean_use, var_use = self._batch_stats(x, mask)
            with torch.no_grad():
                m = self.momentum
                self.moving_mean.copy_(m * self.moving_mean
                                       + (1 - m) * mean_use)
                self.moving_variance.copy_(m * self.moving_variance
                                           + (1 - m) * var_use)
        else:
            mean_use, var_use = self.moving_mean, self.moving_variance
        inv = torch.rsqrt(var_use + self.epsilon)
        scale = (self.gamma * inv).to(x.dtype)
        bias = (self.beta - mean_use * inv * self.gamma).to(x.dtype)
        y = x * scale + bias
        if not self.return_nmd:
            return y, mask
        example_axes = tuple(range(1, x.dim() - 1))
        if self.use_masking and mask is not None:
            mf = mask[..., None]
            per_ex = torch.sum(apply_mask(x, mask), dim=example_axes,
                               dtype=torch.float32)
            cnt = torch.sum(mf, dim=example_axes,
                            dtype=torch.float32) + self.epsilon
            mean_ch = per_ex / cnt
        else:
            n_ex = math.prod(x.shape[a] for a in example_axes)
            mean_ch = torch.sum(x, dim=example_axes,
                                dtype=torch.float32) / n_ex
        nmd = (mean_ch - mean_use).to(x.dtype)
        return y, mask, nmd


class MaskedLayerNorm(nn.Module):
    """Layer norm over channels with f32 moments; masked positions are
    zeroed before the moments and after the affine."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = float(epsilon)
        self.gamma = _param(channels)
        self.beta = _param(channels)

    def forward(self, x, mask=None, train: bool = False):
        if mask is not None:
            x = apply_mask(x, mask)
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True) \
            - torch.square(mean)
        inv = (1.0 / torch.sqrt(var + self.epsilon)).to(x.dtype)
        y = (x - mean.to(x.dtype)) * inv
        y = y * self.gamma.to(x.dtype) + self.beta.to(x.dtype)
        return apply_mask(y, mask), mask


class LayerNorm(nn.Module):
    """Plain (unmasked) layer norm in f32, the output cast back."""

    def __init__(self, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.gamma = _param(channels)
        self.beta = _param(channels)

    def forward(self, x, mask=None, train: bool = False):
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.gamma + self.beta).to(x.dtype), mask


class MaskedDYT(nn.Module):
    """Dynamic-Tanh norm-free layer ``tanh(alpha*x)*gamma + beta``; masked
    positions are re-zeroed after the affine."""

    def __init__(self, channels: int, alpha_init: float = 0.5):
        super().__init__()
        self.alpha_init = float(alpha_init)
        self.alpha = _param(1)
        self.gamma = _param(channels)
        self.beta = _param(channels)

    def dyt_rows(self, dtype: torch.dtype) -> torch.Tensor:
        """(3, C) f32 alpha/gamma/beta rows for the fused kernel, rounded
        through the compute dtype as the layer casts them."""
        c = self.gamma.shape[0]
        rows = torch.stack([self.alpha.expand(c), self.gamma, self.beta])
        return rows.to(dtype).float()

    def forward(self, x, mask=None, train: bool = False):
        y = (torch.tanh(self.alpha.to(x.dtype) * x) * self.gamma.to(x.dtype)
             + self.beta.to(x.dtype))
        return apply_mask(y, mask), mask


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


def masked_global_avg_pool(x, mask=None):
    """Masked mean over (frames, length) -> (B, C)."""
    if mask is None:
        return torch.mean(x, dim=(1, 2)), None
    mf = mask[..., None].to(x.dtype)
    num = torch.sum(x * mf, dim=(1, 2))
    den = torch.clamp_min(torch.sum(mf, dim=(1, 2)), 1e-7)
    return num / den, None


def masked_global_max_pool(x, mask=None):
    """Masked max over (frames, length) with a -1e9 sentinel and an
    all-masked guard."""
    if mask is None:
        return torch.amax(x, dim=(1, 2)), None
    mf = mask[..., None]
    pooled = torch.amax(
        torch.where(mf, x, torch.full((), -1e9, dtype=x.dtype,
                                      device=x.device)), dim=(1, 2))
    has_valid = torch.any(mf, dim=2).any(dim=1)
    return torch.where(has_valid, pooled, torch.zeros_like(pooled)), None


def masked_last_pool(x, mask=None):
    """The last valid position of each frame (the mask's count minus one),
    averaged over the frames that have one."""
    if mask is None:
        return torch.mean(x[:, :, -1, :], dim=1), None
    idx = torch.sum(mask, dim=-1, dtype=torch.int64) - 1        # (B, F)
    gathered = torch.gather(
        x, 2, idx.clamp_min(0)[:, :, None, None].expand(
            -1, -1, 1, x.shape[-1]))[:, :, 0, :]                 # (B, F, C)
    frame_valid = (idx >= 0).to(x.dtype)
    gathered = gathered * frame_valid[..., None]
    count = torch.clamp_min(torch.sum(frame_valid, dim=1, keepdim=True), 1.0)
    return torch.sum(gathered, dim=1) / count, None


class MaskedMaxPooling1D(nn.Module):
    """Max pooling along the length (masked positions zeroed first), the
    mask OR-pooled over the same windows; XLA's VALID or SAME padding."""

    def __init__(self, pool_size: int = 2, strides: int | None = None,
                 padding: str = "valid"):
        super().__init__()
        self.pool_size = int(pool_size)
        self.strides = int(strides or pool_size)
        self.padding = str(padding).upper()

    def forward(self, x, mask=None, train: bool = False):
        if mask is not None:
            x = apply_mask(x, mask)
        pads = (_same_pads(x.shape[2], self.pool_size, self.strides, 1)
                if self.padding == "SAME" else (0, 0))
        xp = F.pad(x, (0, 0, *pads), value=-math.inf)
        y = xp.unfold(2, self.pool_size, self.strides).amax(dim=-1)
        if mask is None:
            return y, None
        mp = F.pad(mask, pads, value=False)
        return y, mp.unfold(2, self.pool_size, self.strides).any(dim=-1)


class GatedFrameGlobalMaxPooling(nn.Module):
    """Per-frame max over the length (unmasked, as in JAX), then a learned
    sigmoid gate per frame normalized over frames. Returns
    ``(pooled, gates)`` with ``gates`` ``(B, F)``."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.gate = Dense(channels, 1, dtype=dtype)

    def forward(self, x, mask=None, train: bool = False):
        per_frame = torch.amax(x, dim=2)                          # (B, F, C)
        gates = torch.sigmoid(self.gate(per_frame))               # (B, F, 1)
        gates = gates / (torch.sum(gates, dim=1, keepdim=True) + 1e-7)
        return torch.sum(per_frame * gates, dim=1), gates[..., 0]


POOLERS = {
    "max": masked_global_max_pool,
    "average": masked_global_avg_pool,
    "max1d": masked_global_max_pool,
    "average1d": masked_global_avg_pool,
    "masked_max": masked_global_max_pool,
    "masked_average": masked_global_avg_pool,
    "last": masked_last_pool,
    "masked_last": masked_last_pool,
    "gatedframe": GatedFrameGlobalMaxPooling,
}


# ---------------------------------------------------------------------------
# Residual blocks
# ---------------------------------------------------------------------------


def _make_norm(norm_type: str, channels: int, return_nmd: bool = False,
               use_masking: bool = True, alpha_init: float = 0.5):
    norm_type = norm_type.lower()
    if norm_type == "masked_batchnorm":
        return MaskedBatchNorm(channels, return_nmd=return_nmd,
                               use_masking=use_masking)
    if norm_type == "masked_layernorm":
        return MaskedLayerNorm(channels)
    if norm_type == "masked_dyt":
        return MaskedDYT(channels, alpha_init=alpha_init)
    if norm_type in ("layernorm", "layer_normalization"):
        return LayerNorm(channels)
    raise ValueError(f"unsupported norm_type {norm_type!r}")


class ResidualBlock(nn.Module):
    """conv-norm-act x2 with optional 1x1 bypass.

    The second conv consumes the first conv's output mask. With
    ``drop_mask_after_conv1`` (the bounded program's cut A) the mask is
    dropped right after conv1: conv1 still pre-zeroes its input, and the
    rest of the block runs mask-free.
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3,
                 strides: int = 1, padding: str = "same",
                 dilation_rate: int = 1, use_bias: bool = True,
                 use_1x1conv: bool = False, activation: str = "gelu",
                 norm_type: str = "masked_batchnorm", alpha_init: float = 0.5,
                 return_nmd: bool = False, use_masking: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if return_nmd and norm_type != "masked_batchnorm":
            raise ValueError("return_nmd requires norm_type='masked_batchnorm'")
        self.activation = activation
        self.return_nmd = bool(return_nmd)
        self.use_masking = bool(use_masking)
        self.dtype = dtype
        conv_kw = dict(kernel_size=kernel_size, padding=padding,
                       dilation_rate=dilation_rate, use_bias=use_bias,
                       use_masking=use_masking, dtype=dtype)
        norm_kw = dict(use_masking=use_masking, alpha_init=alpha_init)
        self.conv1 = MaskedConv1D(in_channels, filters, strides=strides,
                                  **conv_kw)
        self.norm1 = _make_norm(norm_type, filters, **norm_kw)
        self.conv2 = MaskedConv1D(filters, filters, strides=1, **conv_kw)
        self.norm2 = _make_norm(norm_type, filters, return_nmd=return_nmd,
                                **norm_kw)
        self.bypass = bool(use_1x1conv or strides > 1)
        if self.bypass:
            self.conv_bypass = MaskedConv1D(
                in_channels, filters, strides=strides,
                **dict(conv_kw, kernel_size=1))
            self.norm_bypass = _make_norm(norm_type, filters, **norm_kw)

    def _stats_mask(self, norm, m, t, train, bn_stats_all_true):
        """The mask a norm computes statistics under: an all-true one for a
        masked batch norm whose mask the bounded program dropped, when it
        computes batch statistics or NMD means (``bn_stats_all_true``)."""
        if (m is None and bn_stats_all_true and self.use_masking
                and isinstance(norm, MaskedBatchNorm)
                and (train or norm.return_nmd)):
            return torch.ones(t.shape[:-1], dtype=torch.bool, device=t.device)
        return m

    def _conv_norm(self, conv, norm, x, mask, act, residual=None,
                   drop_mask=False, train=False, bn_stats_all_true=False):
        """``act(norm(conv(x)) + residual)`` -> (y, out_mask, nmd).

        Convs with int8 buffers run on the int8 kernel (not in training),
        convs that :meth:`MaskedConv1D.fused` admits on the fused kernel
        (through ``FusedConvBlockFn`` in training); with a DYT norm the
        kernel's epilogue also takes the norm, its re-zero, the residual add
        and the activation.
        """
        masked = conv.use_masking and mask is not None
        b, f, length, _ = x.shape
        k_act = kernel_activation(act, self.dtype)
        int8 = conv.int8 and not train
        if int8 or conv.fused(self.dtype, train):
            conv.record_input(x, mask)
            m_out = None if (drop_mask or not masked) else conv.output_mask(mask)
            l_out = conv_geometry(length, conv.kernel_size,
                                  conv.dilation_rate, conv.padding,
                                  conv.strides)[0]
            bias = (None if conv.bias is None
                    else conv.bias.to(self.dtype).float())
            kw = dict(in_mask=mask.reshape(b * f, length) if masked else None)
            fuse_norm = isinstance(norm, MaskedDYT) and k_act is not None
            if fuse_norm:
                kw.update(
                    dyt=norm.dyt_rows(self.dtype), act=k_act,
                    bias_then_dyt=bias is not None,
                    out_mask=(None if m_out is None
                              else m_out.reshape(b * f, l_out)),
                    residual=(None if residual is None
                              else residual.reshape(b * f, l_out, -1)))
            x3 = x.reshape(b * f, length, -1).to(self.dtype)
            if int8:
                y = int8_conv_dequant(x3, conv.kernel_q, *conv.int8_args(),
                                      bias, use_dyt=fuse_norm,
                                      dilation=conv.dilation_rate,
                                      padding=conv.padding,
                                      stride=conv.strides, **kw)
            elif train:
                y = fused_conv_block_train(x3, conv.kernel, bias, **kw)
            else:
                y = fused_conv_block(x3, conv.kernel.to(self.dtype), bias,
                                     use_dyt=fuse_norm, **kw)
            y = y.reshape(b, f, y.shape[1], -1)
            if fuse_norm:
                return y, m_out, None
        else:
            y, m_out = conv(x, mask)
            if drop_mask:
                m_out = None
        out = norm(y, self._stats_mask(norm, m_out, y, train,
                                       bn_stats_all_true), train)
        y = out[0]
        nmd = out[2] if len(out) == 3 else None
        if residual is not None:
            y = y + residual
        return get_activation(act)(y), m_out, nmd

    def forward(self, x, mask=None, drop_mask_after_conv1: bool = False,
                train: bool = False, bn_stats_all_true: bool = False):
        kw = dict(train=train, bn_stats_all_true=bn_stats_all_true)
        h, m1, _ = self._conv_norm(self.conv1, self.norm1, x, mask,
                                   self.activation,
                                   drop_mask=drop_mask_after_conv1, **kw)
        if self.bypass:
            m2 = (self.conv2.output_mask(m1)
                  if self.conv2.use_masking and m1 is not None else None)
            shortcut, _ = self.conv_bypass(x, mask)
            shortcut = self.norm_bypass(
                shortcut, self._stats_mask(self.norm_bypass, m2, shortcut,
                                           train, bn_stats_all_true),
                train)[0]
        else:
            shortcut = x
        h, m2, nmd = self._conv_norm(self.conv2, self.norm2, h, m1,
                                     self.activation, residual=shortcut, **kw)
        if self.return_nmd:
            return h, m2, nmd
        return h, m2


class ResidualBlockStack(nn.Module):
    """Sequential ResidualBlocks (``block_0`` ...); only the last may emit
    NMD. Cut A drops the mask inside the first block."""

    def __init__(self, in_channels: int, block_size: int, filters: int,
                 use_1x1conv: bool = False, return_nmd: bool = False,
                 dtype=torch.float32, **block_kw):
        super().__init__()
        self.block_size = int(block_size)
        self.return_nmd = bool(return_nmd)
        c = in_channels
        for i in range(self.block_size):
            last = i == self.block_size - 1
            self.add_module(f"block_{i}", ResidualBlock(
                c, filters, use_1x1conv=use_1x1conv if i == 0 else False,
                return_nmd=return_nmd and last, dtype=dtype, **block_kw))
            c = filters

    def forward(self, x, mask=None, drop_mask_after_first_conv1=False,
                train: bool = False, bn_stats_all_true: bool = False):
        """``bn_stats_all_true``: the stack sits after the bounded
        program's cut (see ``ResidualBlock._stats_mask``); cut A sets it
        for every block from its own."""
        nmd = None
        for i in range(self.block_size):
            block = getattr(self, f"block_{i}")
            out = block(x, mask,
                        drop_mask_after_conv1=(drop_mask_after_first_conv1
                                               and i == 0),
                        train=train,
                        bn_stats_all_true=(bn_stats_all_true
                                           or drop_mask_after_first_conv1))
            if block.return_nmd:
                x, mask, nmd = out
            else:
                x, mask = out
        if self.return_nmd:
            return x, mask, nmd
        return x, mask


# ---------------------------------------------------------------------------
# NMD
# ---------------------------------------------------------------------------


class NMDLayer(nn.Module):
    """Standalone neural-mean-discrepancy vector: the per-example channel
    mean minus the moving mean (eval) or the batch mean (train, which also
    updates the moving mean; the global batch's under a process group).
    Side output only."""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.register_buffer("moving_mean", torch.zeros(channels))

    def forward(self, x, mask=None, train: bool = False):
        xf = x.float()
        reduce_axes = tuple(range(xf.dim() - 1))
        example_axes = tuple(range(1, xf.dim() - 1))
        if mask is not None:
            mf = mask.float()[..., None]
            masked = xf * mf
            mean_ch = torch.sum(masked, dim=example_axes) / (
                torch.sum(mf, dim=example_axes) + self.epsilon)
            if train:
                total, count = mh.all_reduce_sum(
                    torch.sum(masked, dim=reduce_axes),
                    torch.sum(mf, dim=reduce_axes))
                mean_b = total / (count + self.epsilon)
        else:
            mean_ch = torch.mean(xf, dim=example_axes)
            if train:
                n = (math.prod(xf.shape[a] for a in reduce_axes)
                     * mh.process_count())
                mean_b = mh.all_reduce_sum(torch.sum(
                    xf, dim=reduce_axes)) / n
        if not train:
            return (mean_ch - self.moving_mean).to(x.dtype)
        with torch.no_grad():
            m = self.momentum
            self.moving_mean.copy_(m * self.moving_mean + (1 - m) * mean_b)
        return (mean_ch - mean_b).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator):
    """``flax.linen.Dropout`` in train mode: keep each element with
    probability ``1 - rate`` (drawn from ``generator``) and scale kept ones
    by ``1 / (1 - rate)``. Under a process group each process draws the
    mask of the global batch (its leading axis times the world size) from
    the same seeded generator and keeps its own rows, so N processes
    drop what one process with the whole batch drops."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    world = mh.process_count()
    shape = (x.shape[0] * world, *x.shape[1:])
    keep = torch.rand(shape, generator=generator,
                      device=generator.device) < (1.0 - rate)
    if world > 1:
        rank = mh.process_index()
        keep = keep[rank * x.shape[0]:(rank + 1) * x.shape[0]]
    return torch.where(keep.to(x.device), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, in_features: int, units: int, use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(in_features, units)
        self.bias = _param(units) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class NMDMerge(nn.Module):
    """Merge NMD vectors: concat / sum / mean / max / learned-softmax.
    Non-concat modes project each input to ``target_dim`` first."""

    def __init__(self, widths: list[int], mode: str = "concat",
                 target_dim: int | None = None, dtype=torch.float32):
        super().__init__()
        if mode not in ("concat", "sum", "mean", "max", "weighted"):
            raise ValueError(f"unsupported NMD merge mode {mode!r}")
        self.mode = mode
        self.n_inputs = len(widths)
        if mode == "concat":
            self.out_features = sum(widths)
            return
        if target_dim is None:
            if len(set(widths)) != 1:
                raise ValueError("target_dim required when NMD dims differ")
            target_dim = widths[0]
        self.out_features = int(target_dim)
        for i, w in enumerate(widths):
            self.add_module(f"proj_{i}", Dense(w, target_dim, use_bias=False,
                                               dtype=dtype))
        if mode == "weighted":
            self.layer_weights = _param(len(widths))

    def forward(self, inputs):
        inputs = list(inputs)
        if self.mode == "concat":
            return torch.cat(inputs, dim=-1)
        projected = [getattr(self, f"proj_{i}")(v)
                     for i, v in enumerate(inputs)]
        if self.mode == "sum":
            return sum(projected)
        if self.mode == "mean":
            return sum(projected) / len(projected)
        if self.mode == "max":
            return torch.amax(torch.stack(projected, 0), dim=0)
        weights = torch.softmax(self.layer_weights, dim=0)[:, None, None]
        return torch.sum(torch.stack(projected, 0) * weights, dim=0)


class OODSignalLayer(nn.Module):
    """Scalar out-of-distribution signals from the logits (and the NMD
    vector), in f32: ``max_prob``, ``entropy``, ``energy``, ``margin``,
    ``nmd_norm``."""

    def __init__(self, signals=("max_prob",), epsilon: float = 1e-10):
        super().__init__()
        self.signals = tuple(signals)
        self.epsilon = float(epsilon)

    def forward(self, logits, nmd=None):
        logits = logits.float()
        probs = torch.softmax(logits, dim=-1)
        cols = []
        for s in self.signals:
            if s == "max_prob":
                cols.append(torch.amax(probs, dim=-1, keepdim=True))
            elif s == "entropy":
                sp = torch.clamp_min(probs, self.epsilon)
                cols.append(-torch.sum(sp * torch.log(sp), dim=-1,
                                       keepdim=True))
            elif s == "energy":
                cols.append(torch.logsumexp(logits, dim=-1, keepdim=True))
            elif s == "margin":
                top2 = torch.topk(probs, 2, dim=-1).values
                cols.append(top2[..., 0:1] - top2[..., 1:2])
            elif s == "nmd_norm":
                if nmd is None:
                    raise ValueError("'nmd_norm' requires an NMD vector")
                cols.append(torch.linalg.vector_norm(nmd.float(), dim=-1,
                                                     keepdim=True))
            else:
                raise ValueError(f"unsupported signal {s!r}")
        return torch.cat(cols, dim=-1)


# ---------------------------------------------------------------------------
# Attention family
# ---------------------------------------------------------------------------


class DenseGeneral(nn.Module):
    """``flax.linen.DenseGeneral`` contracting the trailing ``in_shape``
    axes: kernel ``in_shape + out_shape``, bias ``out_shape``, computed in
    ``dtype``."""

    def __init__(self, in_shape: tuple, out_shape: tuple,
                 dtype=torch.float32):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.kernel = _param(*self.in_shape, *self.out_shape)
        self.bias = _param(*self.out_shape)

    def forward(self, x):
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = (x.to(self.dtype).reshape(*lead, n_in)
             @ self.kernel.to(self.dtype).reshape(n_in, n_out))
        return y.reshape(*lead, *self.out_shape) + self.bias.to(self.dtype)


class MHA(nn.Module):
    """Multi-head self-attention with an output projection: the function
    of JAX's ``_MHA`` (flax ``MultiHeadDotProductAttention``'s tree and
    math). ``query`` / ``key`` / ``value`` kernels ``(C, h, dh)``, ``out``
    ``(h, dh, out_features)`` (``out_features`` defaults to ``embed_dim``,
    the qkv width); the query is pre-scaled by ``1/sqrt(dh)``. Sequence
    axes of at most 16 compute the scores and the weighted values in f32
    and round once, as JAX does there."""

    #: sequence lengths up to this take the f32-accumulated form
    SHORT_SEQ_MAX = 16

    def __init__(self, in_channels: int, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.0, dtype=torch.float32,
                 out_features: int | None = None):
        super().__init__()
        h = int(num_heads)
        dh = int(embed_dim) // h
        self.num_heads, self.head_dim = h, dh
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((in_channels,), (h, dh),
                                               dtype=dtype))
        self.out = DenseGeneral((h, dh), (int(out_features or embed_dim),),
                                dtype=dtype)

    def forward(self, x, attn_mask=None, train: bool = False,
                generator=None):
        """``x`` ``(n, s, C)``; ``attn_mask`` bool, broadcast against the
        ``(n, h, s_q, s_k)`` scores (True = attend)."""
        short = x.shape[1] <= self.SHORT_SEQ_MAX
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / torch.sqrt(torch.tensor(float(self.head_dim))).to(q.dtype)
        if short:
            scores = torch.einsum("nqhd,nkhd->nhqk", q.float(),
                                  k.float()).to(q.dtype)
        else:
            scores = torch.einsum("nqhd,nkhd->nhqk", q, k)
        if attn_mask is not None:
            scores = torch.where(attn_mask, scores,
                                 torch.finfo(self.dtype).min)
        w = torch.softmax(scores, dim=-1)
        if train:
            w = dropout(w, self.dropout_rate, generator)
        if short:
            o = torch.einsum("nhqk,nkhd->nqhd", w.float(),
                             v.float()).to(v.dtype)
        else:
            o = torch.einsum("nhqk,nkhd->nqhd", w, v)
        return self.out(o)


def _train_dropout(x, rate: float, train: bool, generator):
    return dropout(x, rate, generator) if train else x


class TransformerEncoder(nn.Module):
    """Pre-norm attention over the length axis of ``(B, F, L, C)`` and an
    FFN. Invalid keys are excluded (a row with no valid key attends
    uniformly and is re-masked downstream)."""

    def __init__(self, channels: int, embed_dim: int, num_heads: int,
                 feed_forward_dim: int, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.attn_norm = LayerNorm(channels)
        self.mha = MHA(channels, embed_dim, num_heads, dropout_rate,
                       dtype=dtype)
        self.ffn_norm = LayerNorm(embed_dim)
        self.ffn_dense1 = Dense(embed_dim, feed_forward_dim, dtype=dtype)
        self.ffn_dense2 = Dense(feed_forward_dim, embed_dim, dtype=dtype)

    def _ffn(self, h, train, generator):
        rate = self.dropout_rate
        ffn = _gelu(self.ffn_dense1(self.ffn_norm(h)[0]))
        ffn = _train_dropout(ffn, rate, train, generator)
        return _train_dropout(self.ffn_dense2(ffn), rate, train, generator)

    def forward(self, x, mask=None, train: bool = False, generator=None):
        b, f, length, c = x.shape
        h = x.reshape(b * f, length, c)
        attn_mask = (None if mask is None
                     else mask.reshape(b * f, 1, 1, length))
        attn = self.mha(self.attn_norm(h)[0], attn_mask, train, generator)
        h = h + _train_dropout(attn, self.dropout_rate, train, generator)
        h = h + self._ffn(h, train, generator)
        return h.reshape(b, f, length, c), mask


class CrossFrameAttention(TransformerEncoder):
    """Self-attention across the reading frames at each position
    (``(B*L, F, C)``), with an optional FFN; the mask is not used."""

    def __init__(self, channels: int, embed_dim: int, num_heads: int,
                 feed_forward_dim: int, dropout_rate: float = 0.1,
                 use_ffn: bool = True, dtype=torch.float32):
        super().__init__(channels, embed_dim, num_heads, feed_forward_dim,
                         dropout_rate, dtype=dtype)
        self.use_ffn = bool(use_ffn)
        if not self.use_ffn:
            del self.ffn_norm, self.ffn_dense1, self.ffn_dense2

    def forward(self, x, mask=None, train: bool = False, generator=None):
        b, f, length, c = x.shape
        h = x.permute(0, 2, 1, 3).reshape(b * length, f, c)
        attn = self.mha(self.attn_norm(h)[0], None, train, generator)
        h = h + _train_dropout(attn, self.dropout_rate, train, generator)
        if self.use_ffn:
            h = h + self._ffn(h, train, generator)
        return h.reshape(b, length, f, c).permute(0, 2, 1, 3), mask


class AxialAttention(nn.Module):
    """``num_blocks`` of (length attention, frame attention, norm), each
    with a residual around the whole block."""

    def __init__(self, channels: int, embed_dim: int, num_heads: int,
                 feed_forward_dim: int, dropout_rate: float = 0.1,
                 num_blocks: int = 1, norm_type: str = "layernorm",
                 alpha_init: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.num_blocks = int(num_blocks)
        args = (channels, embed_dim, num_heads, feed_forward_dim,
                dropout_rate)
        for i in range(self.num_blocks):
            self.add_module(f"length_attn_{i}",
                            TransformerEncoder(*args, dtype=dtype))
            self.add_module(f"frame_attn_{i}",
                            CrossFrameAttention(*args, dtype=dtype))
            self.add_module(f"post_norm_{i}", _make_norm(
                norm_type, channels, alpha_init=alpha_init))

    def forward(self, x, mask=None, train: bool = False, generator=None):
        for i in range(self.num_blocks):
            residual = x
            x, _ = getattr(self, f"length_attn_{i}")(x, mask, train,
                                                     generator)
            x, _ = getattr(self, f"frame_attn_{i}")(x, mask, train,
                                                    generator)
            x = getattr(self, f"post_norm_{i}")(x, mask, train)[0]
            x = x + residual
        return x, mask


class LocalAttention(nn.Module):
    """Banded self-attention along the length (``window_size // 2`` each
    side, AND'ed with key validity) with an FFN, ``num_blocks`` times."""

    def __init__(self, channels: int, embed_dim: int, num_heads: int,
                 feed_forward_dim: int, window_size: int,
                 dropout_rate: float = 0.1, num_blocks: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = int(window_size)
        self.num_blocks = int(num_blocks)
        for i in range(self.num_blocks):
            self.add_module(f"ln1_{i}", LayerNorm(channels))
            self.add_module(f"mha_{i}", MHA(channels, embed_dim, num_heads,
                                            dropout_rate, dtype=dtype))
            self.add_module(f"ln2_{i}", LayerNorm(embed_dim))
            self.add_module(f"ffn1_{i}", Dense(embed_dim, feed_forward_dim,
                                               dtype=dtype))
            self.add_module(f"ffn2_{i}", Dense(feed_forward_dim, embed_dim,
                                               dtype=dtype))

    def forward(self, x, mask=None, train: bool = False, generator=None):
        b, f, length, c = x.shape
        h = x.reshape(b * f, length, c)
        pos = torch.arange(length, device=x.device)
        attn_mask = ((pos[:, None] - pos[None, :]).abs()
                     <= self.window_size // 2)[None, None]
        if mask is not None:
            attn_mask = attn_mask & mask.reshape(b * f, 1, 1, length)
        for i in range(self.num_blocks):
            hn = getattr(self, f"ln1_{i}")(h)[0]
            h = h + getattr(self, f"mha_{i}")(hn, attn_mask, train,
                                              generator)
            hn = getattr(self, f"ln2_{i}")(h)[0]
            ffn = _gelu(getattr(self, f"ffn1_{i}")(hn))
            h = h + getattr(self, f"ffn2_{i}")(ffn)
        return h.reshape(b, f, length, c), mask


# ---------------------------------------------------------------------------
# Recurrent
# ---------------------------------------------------------------------------


class MaskedBiLSTM(nn.Module):
    """Bidirectional LSTM over the length of ``(B, F, L, C)`` inputs.

    Per direction: the input projection is one matmul in the compute dtype
    (plus the bias), the recurrence a loop of ``h @ U`` steps with gates i,
    f, g, o; the sigmoids and tanh run in the compute dtype. A masked step
    carries ``h`` and ``c`` through unchanged (Keras-style), which is why
    ``torch.nn.LSTM`` cannot run it. The backward direction runs on the
    flipped sequence and mask; both directions step together as one
    ``bmm`` on stacked ``(2, U, 4U)`` weights. ``return_sequences=False``
    gives the forward direction's last step and the backward direction's
    first original step, ``(B, F, 2U)``.
    """

    def __init__(self, channels: int, units: int,
                 return_sequences: bool = True, ignore_mask: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.units = int(units)
        self.return_sequences = bool(return_sequences)
        self.ignore_mask = bool(ignore_mask)
        self.dtype = dtype
        for d in ("fwd", "bwd"):
            setattr(self, f"{d}_kernel", _param(channels, 4 * self.units))
            setattr(self, f"{d}_recurrent", _param(self.units, 4 * self.units))
            setattr(self, f"{d}_bias", _param(4 * self.units))

    def forward(self, x, mask=None, train: bool = False):
        b, f, length, c = x.shape
        u, dt = self.units, self.dtype
        n = b * f
        h = x.reshape(n, length, c)
        m = None
        if mask is not None and not self.ignore_mask:
            m = mask.reshape(n, length)
        seq = torch.stack([h, h.flip(1)]).to(dt)                # (2, N, L, C)
        kernel = torch.stack([self.fwd_kernel, self.bwd_kernel]).to(dt)
        bias = torch.stack([self.fwd_bias, self.bwd_bias]).to(dt)
        xz = torch.matmul(seq, kernel[:, None]) + bias[:, None, None]
        rec = torch.stack([self.fwd_recurrent, self.bwd_recurrent]).to(dt)
        keep = None if m is None else torch.stack([m, m.flip(1)])[..., None]
        h_t = torch.zeros((2, n, u), dtype=dt, device=x.device)
        c_t = h_t
        outs = []
        for t in range(length):
            z = xz[:, :, t] + torch.bmm(h_t, rec)
            i = torch.sigmoid(z[..., :u])
            fg = torch.sigmoid(z[..., u:2 * u])
            g = torch.tanh(z[..., 2 * u:3 * u])
            o = torch.sigmoid(z[..., 3 * u:])
            c_new = fg * c_t + i * g
            h_new = o * torch.tanh(c_new)
            if keep is not None:
                h_new = torch.where(keep[:, :, t], h_new, h_t)
                c_new = torch.where(keep[:, :, t], c_new, c_t)
            h_t, c_t = h_new, c_new
            outs.append(h_t)
        out = torch.stack(outs, 2)                              # (2, N, L, U)
        fwd, bwd = out[0], out[1].flip(1)
        out_mask = None if self.ignore_mask else mask
        if self.return_sequences:
            return (torch.cat([fwd, bwd], dim=-1)
                    .reshape(b, f, length, 2 * u), out_mask)
        last = torch.cat([fwd[:, -1], bwd[:, 0]], dim=-1)
        return last.reshape(b, f, 2 * u), out_mask


# ---------------------------------------------------------------------------
# Hyena long-convolution stack
# ---------------------------------------------------------------------------

# The causal depthwise convolution has four routes, as in JAX (the same
# constants under the same names): bf16 inputs take the direct Toeplitz
# product up to _DIRECT_CONV_MAX_L (and _DIRECT_CONV_MAX_BYTES of operator),
# the blocked Toeplitz form up to _BLOCK_CONV_MAX_L, the chunked scan up to
# _SCAN_CONV_MAX_L; every other input, and every f32 input, the FFT. The
# Toeplitz routes compute in f32 and cast back.
_DIRECT_CONV_MAX_L = 1024
_DIRECT_CONV_MAX_BYTES = 512 * 1024 * 1024
_BLOCK_CONV_MAX_L = 4096
_BLOCK_CONV_CHUNK = 512
_SCAN_CONV_MAX_L = 65536


def _band_sums(gram: torch.Tensor) -> torch.Tensor:
    """``(D, C, C)`` -> ``(D, 2C - 1)``: entry ``t - s + C - 1`` sums the
    diagonal ``t - s`` (the rows, flipped and padded by C, read back C - 1
    short per row, put each diagonal in one column)."""
    d, c, _ = gram.shape
    sheared = F.pad(gram.flip(-1), (0, c)).reshape(d, 2 * c * c)
    return sheared[:, :c * (2 * c - 1)].reshape(d, c, 2 * c - 1).sum(1)


class _BandToeplitzFn(torch.autograd.Function):
    """``(D, 2C - 1)`` taps -> the ``(D, C, C)`` operator ``T[d, t, s] =
    taps[d, t - s + C - 1]`` by a gather; its gradient sums each diagonal
    (``_band_sums``), where autograd of the gather would scatter-add
    ``D C^2`` values into ``D (2C - 1)`` slots (on the card 22 ms for each
    of the Hyena template's operators, 89 % of a train step)."""

    @staticmethod
    def forward(ctx, taps):
        c = (taps.shape[-1] + 1) // 2
        pos = torch.arange(c, device=taps.device)
        return taps[:, pos[:, None] - pos[None, :] + (c - 1)]

    @staticmethod
    def backward(ctx, g):
        return _band_sums(g)


def _causal_toeplitz_convolve(u32: torch.Tensor,
                              h32: torch.Tensor) -> torch.Tensor:
    """``y[b, d, t] = sum_{s <= t} u[b, d, s] h[d, t - s]`` as one batched
    f32 product with the ``(D, L, L)`` lower-triangular Toeplitz operator
    (the filter behind ``L - 1`` zero taps, gathered)."""
    length = u32.shape[-1]
    toep = _BandToeplitzFn.apply(F.pad(h32, (length - 1, 0)))
    return torch.einsum("dts,bds->bdt", toep, u32)


def _scan_conv_forward(u32: torch.Tensor, h32: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """The causal convolution as N banded products of ``chunk``-wide
    blocks, one block-delta at a time: block (i, j) of the ``(L, L)``
    operator depends only on ``delta = i - j``, so ``y[:, :, i] += T_delta
    @ u[:, :, i - delta]`` with ``T_delta[d, t, s] = h[d, delta * chunk + t
    - s]`` (zero outside [0, L): the taps of the filter padded by ``chunk -
    1`` zeros on the left, the causal guard, and to the padded length on
    the right). One ``(D, chunk, chunk)`` operator block is live at a
    time."""
    b, d, length = u32.shape
    n = -(-length // chunk)
    lp = n * chunk
    ub = F.pad(u32, (0, lp - length)).reshape(b, d, n, chunk)
    h_pad = F.pad(h32, (chunk - 1, lp - length))
    acc = torch.zeros((b, d, n, chunk), device=u32.device)
    for delta in range(n):
        toep = _BandToeplitzFn.apply(
            h_pad[:, delta * chunk: delta * chunk + 2 * chunk - 1])
        acc[:, :, delta:] += torch.einsum("dts,bdjs->bdjt", toep,
                                          ub[:, :, :n - delta])
    return acc.reshape(b, d, lp)[..., :length]


def _causal_block_toeplitz_convolve(u32: torch.Tensor, h32: torch.Tensor,
                                    chunk: int = _BLOCK_CONV_CHUNK
                                    ) -> torch.Tensor:
    """The blocked Toeplitz route: ``_scan_conv_forward`` with autograd
    through its loop (JAX unrolls the same loop; the scan route runs it
    under its own backward)."""
    return _scan_conv_forward(u32, h32, chunk)


def _scan_conv_hgrad(u32: torch.Tensor, g32: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Filter gradient of the chunked scan: ``dh[d, tau] = sum_{b, t >=
    tau} g[b, d, t] u[b, d, t - tau]``, the batch-reduced causal
    correlation, one cross-block Gram matrix per block-delta whose diagonal
    sums land in the lag band ``delta * chunk + (t - s)``."""
    b, d, length = u32.shape
    n = -(-length // chunk)
    lp = n * chunk
    up = F.pad(u32, (0, lp - length)).reshape(b, d, n, chunk)
    gp = F.pad(g32, (0, lp - length)).reshape(b, d, n, chunk)
    buf = torch.zeros((d, lp + 2 * chunk - 1), device=u32.device)
    for delta in range(n):
        gram = torch.einsum("bdjt,bdjs->dts", gp[:, :, delta:],
                            up[:, :, :n - delta])
        buf[:, delta * chunk: delta * chunk + 2 * chunk - 1] += \
            _band_sums(gram)
    return buf[:, chunk - 1: chunk - 1 + length]


class _ScanConvFn(torch.autograd.Function):
    """The chunked scan with its own backward, saving only ``(u, h)``:
    autograd through the loop would keep O(b d L^2 / chunk) residuals. The
    op is bilinear: ``du`` is the flipped forward of the flipped gradient,
    ``dh`` the batch-reduced causal correlation (``_scan_conv_hgrad``)."""

    @staticmethod
    def forward(ctx, u32, h32, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(u32, h32)
        return _scan_conv_forward(u32, h32, chunk)

    @staticmethod
    def backward(ctx, g):
        u32, h32 = ctx.saved_tensors
        g32 = g.float()
        du = _scan_conv_forward(g32.flip(-1), h32, ctx.chunk).flip(-1)
        return du, _scan_conv_hgrad(u32, g32, ctx.chunk), None


def _causal_chunked_scan_convolve(u32: torch.Tensor, h32: torch.Tensor,
                                  chunk: int = _BLOCK_CONV_CHUNK
                                  ) -> torch.Tensor:
    return _ScanConvFn.apply(u32, h32, int(chunk))


def causal_fft_convolve(u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of ``u`` ``(B, D, L)`` with ``h``
    ``(D, L)`` in u's dtype, by the route JAX's dispatch picks (see the
    constants above); the FFT route is an f32 rFFT of length ``2L - 1``."""
    orig = u.dtype
    u32, h32 = u.float(), h.float()
    length = u.shape[-1]
    d = h.shape[0]
    if orig == torch.bfloat16:
        if (length <= _DIRECT_CONV_MAX_L
                and d * length * length * 4 <= _DIRECT_CONV_MAX_BYTES):
            return _causal_toeplitz_convolve(u32, h32).to(orig)
        nblk = -(-length // _BLOCK_CONV_CHUNK)
        if (length <= _BLOCK_CONV_MAX_L
                and d * nblk * _BLOCK_CONV_CHUNK ** 2 * 4
                <= _DIRECT_CONV_MAX_BYTES):
            return _causal_block_toeplitz_convolve(
                u32, h32, chunk=_BLOCK_CONV_CHUNK).to(orig)
        if (length <= _SCAN_CONV_MAX_L
                and d * _BLOCK_CONV_CHUNK ** 2 * 4 <= _DIRECT_CONV_MAX_BYTES):
            return _causal_chunked_scan_convolve(
                u32, h32, chunk=_BLOCK_CONV_CHUNK).to(orig)
    n = 2 * length - 1
    spec = torch.fft.rfft(u32, n=n, dim=-1) * torch.fft.rfft(h32, n=n,
                                                              dim=-1)[None]
    return torch.fft.irfft(spec, n=n, dim=-1)[..., :length].to(orig)


class HyenaFilter(nn.Module):
    """Implicit filters ``h_t = window(t) * FFN(PE(t))``: ``(order, dim,
    L)`` f32 whatever the model's dtype (JAX's ``nn.Dense`` here has no
    dtype). Per order an FFN ``ffn_{i}_dense_{j}`` of ``sin_pe``, the
    decay window ``exp(-|alpha| t) + bias``, optionally unit L2 norm per
    channel."""

    def __init__(self, dim: int, order: int = 2, pe_dim: int = 16,
                 hidden_dim: int = 32, num_layers: int = 2,
                 activation: str = "gelu", normalize: bool = False):
        super().__init__()
        self.order = int(order)
        self.pe_dim = int(pe_dim)
        self.num_layers = int(num_layers)
        self.activation = activation
        self.normalize = bool(normalize)
        self.alphas = _param(self.order, dim)
        self.biases = _param(self.order, dim)
        for i in range(self.order):
            width = self.pe_dim
            for j in range(self.num_layers):
                units = dim if j == self.num_layers - 1 else hidden_dim
                self.add_module(f"ffn_{i}_dense_{j}", Dense(width, units))
                width = units

    def forward(self, length: int) -> torch.Tensor:
        dev = self.alphas.device
        pe = sin_pe(length, self.pe_dim, device=dev)
        alphas = self.alphas.abs()
        t = torch.arange(length, dtype=torch.float32, device=dev)
        act = get_activation(self.activation)
        filters = []
        for i in range(self.order):
            h = pe
            for j in range(self.num_layers):
                h = getattr(self, f"ffn_{i}_dense_{j}")(h)
                if j < self.num_layers - 1:
                    h = act(h)
            window = torch.exp(-alphas[i][None, :] * t[:, None]) \
                + self.biases[i][None, :]
            filt = window * h                                   # (L, dim)
            if self.normalize:
                norm = torch.linalg.vector_norm(filt, dim=0, keepdim=True)
                filt = torch.where(norm > 0,
                                   filt / torch.clamp(norm, min=1e-12),
                                   torch.zeros((), device=dev))
            filters.append(filt)
        return torch.stack(filters, 0).transpose(1, 2)


class HyenaOperator(nn.Module):
    """Order-N gated long-convolution recurrence on ``(B, L, C)``:
    ``order + 1`` bias-free projections ``proj_i`` in the compute dtype,
    then ``z <- causal_conv(z, h_i) * gate_i``.

    The projections are computed as ``W^T x^T`` into ``(dim, L, B)``
    memory (one transposing copy of ``x``) and viewed as ``(B, dim, L)``:
    the Toeplitz product's batched operand, its result and the gates then
    share one layout, so the recurrence copies nothing between its
    products and gates (in the ``(B, L, dim)`` layout the casts and gate
    products read across strides: 40 % of the template's forward at batch
    2048 on an H100).
    """

    def __init__(self, channels: int, dim: int, order: int = 2,
                 filter_hidden: int = 32, filter_layers: int = 2,
                 filter_activation: str = "gelu",
                 filter_normalize: bool = False, dtype=torch.float32,
                 seq_axis: str | None = None):
        super().__init__()
        self.order = int(order)
        self.seq_axis = seq_axis
        for i in range(self.order + 1):
            self.add_module(f"proj_{i}", Dense(channels, dim, use_bias=False,
                                               dtype=dtype))
        self.filter = HyenaFilter(dim, order=self.order,
                                  hidden_dim=filter_hidden,
                                  num_layers=filter_layers,
                                  activation=filter_activation,
                                  normalize=filter_normalize)

    def forward(self, x):
        b, length, c = x.shape
        dt = self.proj_0.dtype
        xt = x.to(dt).permute(2, 1, 0).reshape(c, length * b)
        proj = [(getattr(self, f"proj_{i}").kernel.to(dt).t() @ xt)
                .reshape(-1, length, b).permute(2, 0, 1)     # (B, dim, L)
                for i in range(self.order + 1)]
        filters = self.filter(length)
        if self.seq_axis:
            return self._sharded_recurrence(proj, filters).transpose(1, 2)
        z = proj[0]
        for i in range(self.order):
            z = causal_fft_convolve(z, filters[i]) * proj[i + 1]
        return z.transpose(1, 2)

    def _sharded_recurrence(self, proj, filters):
        """The recurrence length-sharded over the ambient mesh
        (:func:`jaeger_tpu_torch.parallel.mesh.use_mesh`), whose axis must
        be ``seq_axis`` (:mod:`jaeger_tpu_torch.parallel.hyena_sp`'s ring).
        L is right-padded to a multiple of the mesh size with zero
        projections and zero filter taps; causality keeps the first L
        outputs those of the unpadded recurrence."""
        from jaeger_tpu_torch.parallel.hyena_sp import hyena_recurrence_sp
        from jaeger_tpu_torch.parallel.mesh import current_mesh

        mesh = current_mesh()
        if mesh is None or mesh.axis != self.seq_axis:
            raise ValueError(
                f"seq_axis {self.seq_axis!r} not in the ambient mesh "
                f"{mesh}; run under parallel.mesh.use_mesh(DeviceMesh(..., "
                f"{self.seq_axis!r}))")
        length = proj[0].shape[-1]
        pad = -(-length // mesh.size) * mesh.size - length
        if pad:
            proj = [F.pad(p, (0, pad)) for p in proj]
            filters = F.pad(filters, (0, pad))
        return hyena_recurrence_sp(proj, filters, mesh)[..., :length]


class HyenaBlock(nn.Module):
    """Mask, ``LayerNorm``, mask, the Hyena operator over each frame's
    length, ``out_proj`` (``output_projection``), dropout from the
    caller's generator, the residual, mask again."""

    def __init__(self, channels: int, dim: int, order: int = 2,
                 filter_hidden: int = 32, filter_layers: int = 2,
                 filter_activation: str = "gelu", dropout: float = 0.0,
                 output_projection: bool = False,
                 filter_normalize: bool = False, dtype=torch.float32,
                 seq_axis: str | None = None):
        super().__init__()
        self.dropout = float(dropout)
        self.norm = LayerNorm(channels)
        self.hyena = HyenaOperator(
            channels, dim, order=order, filter_hidden=filter_hidden,
            filter_layers=filter_layers, filter_activation=filter_activation,
            filter_normalize=filter_normalize, dtype=dtype,
            seq_axis=seq_axis)
        self.out_proj = (Dense(dim, dim, dtype=dtype) if output_projection
                         else None)

    def forward(self, x, mask=None, train: bool = False, generator=None):
        b, f, length, _ = x.shape
        x = apply_mask(x, mask)
        h = apply_mask(self.norm(x)[0], mask)
        h = self.hyena(h.reshape(b * f, length, -1))
        if self.out_proj is not None:
            h = self.out_proj(h)
        h = _train_dropout(h, self.dropout, train, generator)
        out = h.reshape(b, f, length, -1) + x
        return apply_mask(out, mask), mask


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


class OneHotEmbed(nn.Module):
    """Token embedding with the flax tree's ``embedding`` table. A row
    lookup equals the JAX layer's one-hot matmul exactly (one nonzero per
    row)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param(num_embeddings, features)

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding.to(self.dtype))


def sin_pe(length: int, dim: int, device=None) -> torch.Tensor:
    """``(length, dim)`` f32 interleaved sin/cos table at geometric
    frequencies (the Hyena filters' positional input, JAX ``_sin_pe``)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * -(math.log(10000.0) / dim))
    pe = torch.stack([torch.sin(pos * div), torch.cos(pos * div)], dim=-1)
    return pe.reshape(length, -1)[:, :dim]


class SinusoidalPositionEmbedding(nn.Module):
    """Sin/cos positional encoding over the length axis (sin on even
    channels, cos on odd ones), broadcast to ``x``'s shape in its dtype."""

    def __init__(self, max_wavelength: float = 10000.0):
        super().__init__()
        self.max_wavelength = float(max_wavelength)

    def forward(self, x):
        length, hidden = x.shape[-2], x.shape[-1]
        positions = torch.arange(length, dtype=torch.float32,
                                 device=x.device)
        dims = torch.arange(hidden, dtype=torch.float32, device=x.device)
        even = torch.floor(dims / 2) * 2
        base = torch.tensor(1.0 / self.max_wavelength, dtype=torch.float32,
                            device=x.device)
        angles = positions[:, None] * torch.pow(base, even / hidden)[None, :]
        sin_mask = (dims % 2 == 0).float()
        pe = torch.sin(angles) * sin_mask + torch.cos(angles) * (1 - sin_mask)
        return torch.broadcast_to(pe, x.shape).to(x.dtype)
