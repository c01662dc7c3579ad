"""The masked layer zoo in PyTorch: the inference subset of the main path.

Counterpart of `jaeger_tpu/models/layers.py`. Layouts are the JAX
package's: activations ``(B, F, L, C)`` channels-last, masks ``(B, F, L)``
bool, and every layer returns ``(y, mask)``. Parameters keep the flax
names and shapes (conv kernels ``(k, C_in, C_out)``, dense kernels
``(in, out)``) and are stored in f32; each layer casts them to its compute
dtype as the flax layers do. Ported: activations, ``apply_mask``,
``MaskedConv1D`` (with its int8 branch and calibration), ``MaskedBatchNorm``,
``MaskedDYT``, the global max/average poolers, ``ResidualBlock`` and
``ResidualBlockStack``, ``NMDLayer``, ``NMDMerge``, ``Dense``,
``OneHotEmbed`` and ``dropout``.

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
conv through :func:`jaeger_tpu_torch.ops.fused_conv.fused_conv_block`
(the Hopper kernel on CUDA, its plain version on the CPU); with DYT norms
the norm, its re-zero, the shortcut add and the activation ride the
kernel's epilogue.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from jaeger_tpu_torch.ops.fused_conv import fused_conv_block
from jaeger_tpu_torch.ops.fused_conv_grad import fused_conv_block_train
from jaeger_tpu_torch.ops.int8_conv import conv_geometry, int8_conv_dequant

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
        """Whether the fused kernel computes this conv."""
        return (self.padding == "SAME" and self.strides == 1
                and self.dilation_rate == 1
                and self.in_channels == self.filters)

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
        if self.strides != 1:
            raise NotImplementedError(
                "int8 execution of strided convs is not yet ported to "
                "jaeger_tpu_torch")
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
                padding=self.padding,
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
        """(mean, variance) over every axis but channels, in f32."""
        reduce_axes = tuple(range(x.dim() - 1))
        if self.use_masking and mask is not None:
            mf = mask[..., None]
            valid = torch.sum(mf, dim=reduce_axes,
                              dtype=torch.float32) + self.epsilon
            mean = torch.sum(apply_mask(x, mask), dim=reduce_axes,
                             dtype=torch.float32) / valid
            sq = torch.square(x.float() - mean) * mf.float()
            return mean, torch.sum(sq, dim=reduce_axes) / valid
        n = math.prod(x.shape[a] for a in reduce_axes)
        mean = torch.sum(x, dim=reduce_axes, dtype=torch.float32) / n
        return mean, (torch.sum(torch.square(x.float()), dim=reduce_axes) / n
                      - torch.square(mean))

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


POOLERS = {
    "max": masked_global_max_pool,
    "average": masked_global_avg_pool,
    "max1d": masked_global_max_pool,
    "average1d": masked_global_avg_pool,
    "masked_max": masked_global_max_pool,
    "masked_average": masked_global_avg_pool,
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
    if norm_type == "masked_dyt":
        return MaskedDYT(channels, alpha_init=alpha_init)
    raise NotImplementedError(
        f"norm_type {norm_type!r} is not yet ported to jaeger_tpu_torch")


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
        other fusable convs on the fused kernel (through
        ``FusedConvBlockFn`` in training); with a DYT norm the kernel's
        epilogue also takes the norm, its re-zero, the residual add and the
        activation.
        """
        masked = conv.use_masking and mask is not None
        b, f, length, _ = x.shape
        k_act = kernel_activation(act, self.dtype)
        int8 = conv.int8 and not train
        if int8 or conv.fusable:
            conv.record_input(x, mask)
            m_out = None if (drop_mask or not masked) else conv.output_mask(mask)
            l_out = conv_geometry(length, conv.kernel_size,
                                  conv.dilation_rate, conv.padding)[0]
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
                                      padding=conv.padding, **kw)
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
    updates the moving mean). Side output only."""

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
                mean_b = torch.sum(masked, dim=reduce_axes) / (
                    torch.sum(mf, dim=reduce_axes) + self.epsilon)
        else:
            mean_ch = torch.mean(xf, dim=example_axes)
            if train:
                mean_b = torch.mean(xf, dim=reduce_axes)
        if not train:
            return (mean_ch - self.moving_mean).to(x.dtype)
        with torch.no_grad():
            m = self.momentum
            self.moving_mean.copy_(m * self.moving_mean + (1 - m) * mean_b)
        return (mean_ch - mean_b).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator):
    """``flax.linen.Dropout`` in train mode: keep each element with
    probability ``1 - rate`` (drawn from ``generator``) and scale kept ones
    by ``1 / (1 - rate)``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) < (1.0 - rate)
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
