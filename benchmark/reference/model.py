"""The Jaeger fragment model in plain PyTorch, float32, with TF32 off.

Written from the model's published description (upstream Jaeger's Keras
layers, as the configuration schema names them): a token embedding, the
representation learner's layers in order, a masked pooling over the six
frames and the positions, the classifier head on the pooled vector and the
reliability head on the concatenated NMD vectors. The mask of a window is
its valid tokens; a masked convolution zeroes its masked inputs and keeps
an output position where any input under its window was valid; DYT
re-zeroes masked positions; batch norm, attention and the heads do not.

The layers this module knows are the ones the benchmark's configurations
use: ``masked_conv1d``, ``masked_dyt``, ``masked_batchnorm`` (inference
statistics), ``nmd``, ``gelu``, ``residual_block`` (DYT or batch norm),
``cross_frame_attention``, ``dense``, ``dropout``, average and max
pooling. Another layer raises. Dropout in a training forward keeps an
element where ``torch.rand`` of the layer's input shape, drawn from the
step's generator, lies below ``1 - rate``, and scales kept elements by
``1 / (1 - rate)``: the masks of a generator seeded as the program's.

Parameters are a flat dict keyed by the dotted path of the flax tree
(``rep.residual_block_4.block_0.conv1.kernel``); :func:`param_specs`
lists them from the configuration. ``rounding`` other than ``float32``
rounds every matrix product's operands and result (convolutions, dense
layers, attention, the embedding lookup) and every activation a layer
hands on (each layer's output, the pooled vector, the NMD vectors), as a
program stores them, and the gradient flowing back through each
rounding: ``bfloat16`` rounds them to bf16 and leaves a dense layer the
configuration states in float32 unrounded (the configuration's own
precision, the yardstick of the comparison); ``float8`` rounds them to
float8 e4m3 at a per-tensor scale and such a dense layer to bf16, one
step below the configuration's precision: the control that a lower
precision than the configuration's has to fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.windows import VOCAB

F8_MAX = 448.0


def _round_f8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale."""
    scale = torch.clamp_min(x.abs().amax() / F8_MAX, 1e-30)
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _F8(torch.autograd.Function):
    """Round to float8 e4m3 at a per-tensor scale, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return _round_f8(x.detach())

    @staticmethod
    def backward(ctx, g):
        return _round_f8(g)


class _BF16(torch.autograd.Function):
    """Round to bfloat16, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return x.detach().to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


#: rounding -> (what it applies to bf16 layers, to float32 layers)
ROUNDINGS = {"float32": (None, None), "bfloat16": (_BF16, None),
             "float8": (_F8, _BF16)}


def _layers(section: dict | None) -> list[tuple[str, dict]]:
    return [(e["name"], dict(e.get("config") or {}))
            for e in (section or {}).get("hidden_layers", [])]


def crop_nt(model_cfg: dict) -> int:
    """Nucleotide crop of a translated model: ``3 * codons + 5``."""
    return 3 * int(model_cfg["string_processor"]["crop_size"]) + 5


def param_specs(model_cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """Every parameter and statistic as ``(name, shape, kind, fan_in)``;
    ``kind`` is ``kernel``, ``embedding``, ``bias``, ``alpha``, ``gamma``,
    ``beta``, ``mean`` or ``variance``."""
    specs: list[tuple[str, tuple, str, int]] = []
    emb = model_cfg["embedding"]
    c = int(emb["embedding_size"])
    specs.append(("embedding.embedding", (VOCAB, c), "embedding", 1))

    def conv(prefix, cin, cout, k):
        specs.append((f"{prefix}.kernel", (k, cin, cout), "kernel", k * cin))
        specs.append((f"{prefix}.bias", (cout,), "bias", 1))

    def dyt(prefix, ch):
        specs.append((f"{prefix}.alpha", (1,), "alpha", 1))
        specs.append((f"{prefix}.gamma", (ch,), "gamma", 1))
        specs.append((f"{prefix}.beta", (ch,), "beta", 1))

    def bn(prefix, ch):
        specs.append((f"{prefix}.gamma", (ch,), "gamma", 1))
        specs.append((f"{prefix}.beta", (ch,), "beta", 1))
        specs.append((f"{prefix}.moving_mean", (ch,), "mean", 1))
        specs.append((f"{prefix}.moving_variance", (ch,), "variance", 1))

    def dense(prefix, cin, cout):
        specs.append((f"{prefix}.kernel", (cin, cout), "kernel", cin))
        specs.append((f"{prefix}.bias", (cout,), "bias", 1))

    def norm(prefix, kind, ch):
        (dyt if kind == "masked_dyt" else bn)(prefix, ch)

    nmd_width = 0
    for i, (name, cfg) in enumerate(_layers(model_cfg["representation_learner"])):
        p = f"rep.{name}_{i}"
        if name == "masked_conv1d":
            conv(p, c, int(cfg["filters"]), int(cfg["kernel_size"]))
            c = int(cfg["filters"])
        elif name == "masked_dyt":
            dyt(p, c)
        elif name == "masked_batchnorm":
            bn(p, c)
            nmd_width += c if cfg.get("return_nmd") else 0
        elif name == "nmd":
            specs.append((f"{p}.moving_mean", (c,), "mean", 1))
            nmd_width += c
        elif name == "residual_block":
            f, k = int(cfg["filters"]), int(cfg.get("kernel_size", 3))
            kind = cfg.get("norm_type", "masked_batchnorm")
            for j in range(int(cfg.get("block_size", 1))):
                conv(f"{p}.block_{j}.conv1", c, f, k)
                norm(f"{p}.block_{j}.norm1", kind, f)
                conv(f"{p}.block_{j}.conv2", f, f, k)
                norm(f"{p}.block_{j}.norm2", kind, f)
                c = f
            nmd_width += c if cfg.get("return_nmd") else 0
        elif name == "cross_frame_attention":
            e, h = int(cfg["embed_dim"]), int(cfg["num_heads"])
            ff = int(cfg["feed_forward_dim"])
            specs.append((f"{p}.attn_norm.gamma", (c,), "gamma", 1))
            specs.append((f"{p}.attn_norm.beta", (c,), "beta", 1))
            for qkv in ("query", "key", "value"):
                specs.append((f"{p}.mha.{qkv}.kernel", (c, h, e // h), "kernel", c))
                specs.append((f"{p}.mha.{qkv}.bias", (h, e // h), "bias", 1))
            specs.append((f"{p}.mha.out.kernel", (h, e // h, e), "kernel", e))
            specs.append((f"{p}.mha.out.bias", (e,), "bias", 1))
            specs.append((f"{p}.ffn_norm.gamma", (e,), "gamma", 1))
            specs.append((f"{p}.ffn_norm.beta", (e,), "beta", 1))
            dense(f"{p}.ffn_dense1", e, ff)
            dense(f"{p}.ffn_dense2", ff, e)
            c = e
        elif name != "gelu":
            raise ValueError(f"the reference has no layer {name!r}")
    for head, width in (("classifier", c), ("reliability", nmd_width)):
        section = model_cfg.get("reliability_model" if head == "reliability"
                                else head)
        for i, (name, cfg) in enumerate(_layers(section)):
            if name == "dense":
                dense(f"{head}.{name}_{i}", width, int(cfg["units"]))
                width = int(cfg["units"])
            elif name not in ("gelu", "dropout"):
                raise ValueError(f"the reference has no head layer {name!r}")
    return specs


class Reference:
    """The forward and the training loss of one configuration."""

    def __init__(self, model_cfg: dict, params: dict[str, torch.Tensor],
                 rounding: str = "float32",
                 generator: torch.Generator | None = None):
        if rounding not in ROUNDINGS:
            raise ValueError(f"no rounding {rounding!r}")
        self.cfg = model_cfg
        self.p = params
        self.rounding = rounding
        self.generator = generator

    # -- products ---------------------------------------------------------

    def _q(self, x, f32: bool = False):
        """``x`` as the rounding stores it (``f32``: a float32 layer's)."""
        step = ROUNDINGS[self.rounding][int(f32)]
        return x if step is None else step.apply(x)

    def _conv(self, x, mask, prefix, cfg):
        """Masked SAME/VALID conv of (B, F, L, C) -> (y, out_mask)."""
        kernel = self.p[f"{prefix}.kernel"]
        k = kernel.shape[0]
        b, f, length, c = x.shape
        if mask is not None:
            x = x * mask[..., None]
        same = str(cfg.get("padding", "valid")).lower() == "same"
        lo = (k - 1) // 2 if same else 0
        hi = k - 1 - lo if same else 0
        xin = F.pad(x.reshape(b * f, length, c).transpose(1, 2), (lo, hi))
        y = self._q(F.conv1d(self._q(xin), self._q(kernel).permute(2, 1, 0)))
        y = y.transpose(1, 2) + self.p[f"{prefix}.bias"]
        out_len = y.shape[1]
        y = y.reshape(b, f, out_len, -1)
        if mask is None:
            return y, None
        m = F.pad(mask.reshape(b * f, 1, length).float(), (lo, hi))
        hits = F.conv1d(m, torch.ones(1, 1, k, device=m.device))
        return y, (hits.reshape(b, f, out_len) > 0.5)

    def _dense(self, x, prefix, f32: bool = False):
        kernel = self._q(self.p[f"{prefix}.kernel"], f32)
        return self._q(self._q(x, f32) @ kernel, f32) + self.p[f"{prefix}.bias"]

    def _dropout(self, x, rate: float):
        keep = torch.rand(x.shape, generator=self.generator,
                          device=self.generator.device) < (1.0 - rate)
        return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros_like(x))

    # -- layers -------------------------------------------------------------

    def _dyt(self, x, mask, prefix):
        y = (torch.tanh(self.p[f"{prefix}.alpha"] * x) * self.p[f"{prefix}.gamma"]
             + self.p[f"{prefix}.beta"])
        return y if mask is None else y * mask[..., None]

    def _masked_mean(self, x, mask):
        """Per-example channel mean over the valid (frame, position)s."""
        if mask is None:
            return x.mean(dim=(1, 2))
        mf = mask[..., None].float()
        return (x * mf).sum(dim=(1, 2)) / (mf.sum(dim=(1, 2)) + 1e-5)

    def _bn(self, x, prefix):
        mean, var = self.p[f"{prefix}.moving_mean"], self.p[f"{prefix}.moving_variance"]
        return ((x - mean) / torch.sqrt(var + 1e-5) * self.p[f"{prefix}.gamma"]
                + self.p[f"{prefix}.beta"])

    def _norm(self, kind, x, mask, prefix):
        return self._dyt(x, mask, prefix) if kind == "masked_dyt" else self._bn(x, prefix)

    def _layer_norm(self, x, prefix):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + 1e-6) * self.p[f"{prefix}.gamma"]
                + self.p[f"{prefix}.beta"])

    def _attention(self, x, prefix, cfg):
        """Pre-norm self-attention across the six frames at each position,
        then the feed-forward block; both with residuals."""
        b, f, length, c = x.shape
        h = x.permute(0, 2, 1, 3).reshape(b * length, f, c)
        a = self._layer_norm(h, f"{prefix}.attn_norm")

        def proj(name):
            w = self.p[f"{prefix}.mha.{name}.kernel"]
            return (self._q(torch.einsum("nsc,chd->nshd", self._q(a), self._q(w)))
                    + self.p[f"{prefix}.mha.{name}.bias"])

        q, k, v = proj("query"), proj("key"), proj("value")
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(self._q(torch.einsum("nqhd,nkhd->nhqk", self._q(q),
                                               self._q(k))), -1)
        o = self._q(torch.einsum("nhqk,nkhd->nqhd", self._q(w), self._q(v)))
        out = (self._q(torch.einsum("nqhd,hde->nqe", self._q(o),
                                    self._q(self.p[f"{prefix}.mha.out.kernel"])))
               + self.p[f"{prefix}.mha.out.bias"])
        h = h + out
        ff = F.gelu(self._dense(self._layer_norm(h, f"{prefix}.ffn_norm"),
                                f"{prefix}.ffn_dense1"))
        h = h + self._dense(ff, f"{prefix}.ffn_dense2")
        return h.reshape(b, length, f, -1).permute(0, 2, 1, 3)

    def _head(self, section, head, x, train):
        for i, (name, cfg) in enumerate(_layers(section)):
            if name == "dense":
                x = self._dense(x, f"{head}.{name}_{i}",
                                f32=cfg.get("dtype") == "float32")
            elif name == "gelu":
                x = F.gelu(x)
            elif name == "dropout" and train and float(cfg.get("rate", 0.5)) > 0:
                x = self._dropout(x, float(cfg.get("rate", 0.5)))
        return x

    # -- the model ------------------------------------------------------------

    def forward(self, tokens: torch.Tensor, train: bool = False,
                heads=("prediction", "reliability")) -> dict[str, torch.Tensor]:
        """Logits of (B, 6, K) tokens: ``prediction`` (B, classes) and
        ``reliability`` (B, 1). ``train``: the training forward (no NMD
        taps are read by the classifier; batch statistics are not
        supported)."""
        mask = tokens != 0
        x = self._q(self.p["embedding.embedding"])[tokens]
        nmds = []
        for i, (name, cfg) in enumerate(_layers(self.cfg["representation_learner"])):
            p = f"rep.{name}_{i}"
            if name == "masked_conv1d":
                x, mask = self._conv(x, mask, p, cfg)
            elif name == "masked_dyt":
                x = self._dyt(x, mask, p)
            elif name == "nmd":
                nmds.append(self._masked_mean(x, mask) - self.p[f"{p}.moving_mean"])
            elif name == "masked_batchnorm":
                if train:
                    raise NotImplementedError("batch statistics in training")
                if cfg.get("return_nmd"):
                    nmds.append(self._masked_mean(x, mask) - self.p[f"{p}.moving_mean"])
                x = self._bn(x, p)
            elif name == "gelu":
                x = F.gelu(x)
            elif name == "cross_frame_attention":
                x = self._attention(x, p, cfg)
            elif name == "residual_block":
                kind = cfg.get("norm_type", "masked_batchnorm")
                if train and kind != "masked_dyt":
                    raise NotImplementedError("batch statistics in training")
                blocks = int(cfg.get("block_size", 1))
                conv_cfg = dict(cfg, padding=cfg.get("padding", "same"))
                for j in range(blocks):
                    q = f"{p}.block_{j}"
                    h, m1 = self._conv(x, mask, f"{q}.conv1", conv_cfg)
                    h = self._q(F.gelu(self._norm(kind, h, m1, f"{q}.norm1")))
                    y, m2 = self._conv(h, m1, f"{q}.conv2", conv_cfg)
                    if cfg.get("return_nmd") and j == blocks - 1:
                        nmds.append(self._masked_mean(y, m2)
                                    - self.p[f"{q}.norm2.moving_mean"])
                    x = F.gelu(self._norm(kind, y, m2, f"{q}.norm2") + x)
                    mask = m2
            x = self._q(x)
        pooling = str(self.cfg["representation_learner"].get("pooling", "average"))
        if pooling == "average":
            mf = mask[..., None].float()
            pooled = (x * mf).sum(dim=(1, 2)) / torch.clamp_min(mf.sum(dim=(1, 2)), 1e-7)
        elif pooling == "max":
            pooled = torch.where(mask[..., None], x, torch.full_like(x, -1e9)).amax(dim=(1, 2))
            pooled = torch.where(mask.any(dim=(1, 2))[:, None], pooled,
                                 torch.zeros_like(pooled))
        else:
            raise ValueError(f"the reference has no pooling {pooling!r}")
        pooled = self._q(pooled)
        out = {}
        if "prediction" in heads:
            out["prediction"] = self._head(self.cfg["classifier"], "classifier",
                                           pooled, train)
        if "reliability" in heads and self.cfg.get("reliability_model"):
            out["reliability"] = self._head(self.cfg["reliability_model"],
                                            "reliability",
                                            torch.cat([self._q(n) for n in nmds], -1),
                                            train)
        return out
