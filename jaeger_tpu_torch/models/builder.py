"""YAML-driven model construction (PyTorch).

Counterpart of `jaeger_tpu/models/builder.py`: the same config schema
(``embedding``, ``string_processor``, ``representation_learner``,
``classifier``, ``projection``, ``reliability_model``) builds one
``nn.Module`` whose
forward pass runs the device-side codon encoding, the embedding, the
representation learner and the heads. Module and parameter names follow
the flax tree (``rep.residual_block_3.block_0.conv1.kernel`` is flax's
``params/rep/residual_block_3/block_0/conv1/kernel``), so
:func:`jaeger_tpu_torch.models.artifacts.params_from_jax` is a rename.

The pure-Python planners ``mask_cut_plan``, ``_conv_shrinks``,
``_resolve_crop_nt``, ``_freeze_layers`` and ``regularizer_specs`` are
copies of the JAX module's. ``forward(..., train=True, heads=...)`` is the
training forward (batch statistics, dropout, the fused convs' backward);
``heads`` selects the output heads as the JAX model's does, so a
classifier step never runs the NMD taps or updates their moving means.
The port always re-zeroes after DYT norms, so it needs none of the JAX
builder's defer-remask analysis. ``model.remat`` recomputes each residual
stack and Hyena block of the representation learner in the backward
(``torch.utils.checkpoint``; :func:`_remat`), as JAX's ``nn.remat``.
``model.parallel.seq_axis`` builds the Hyena blocks length-sharded over
the ambient mesh of that axis (:mod:`jaeger_tpu_torch.parallel.hyena_sp`);
the parameters are the same with or without it.

Spans (:mod:`jaeger_tpu_torch.utils.spans`): ``model/encode`` and
``model/heads`` in the forward, and one ``model/<kind>`` around each layer
of a stack (every activation layer ``model/activation``, the pooler
``model/pooling``), so a profiler's trace names the layer that enqueued
each kernel.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from jaeger_tpu_torch.models import layers as L
from jaeger_tpu_torch.ops import encode
from jaeger_tpu_torch.seqops import crop as crop_contract
from jaeger_tpu_torch.seqops import maps
from jaeger_tpu_torch.utils.spans import span

_CONV_KEYS = (
    "filters", "kernel_size", "strides", "padding", "dilation_rate",
    "activation", "use_bias", "use_masking", "mask_mode",
)
_RES_KEYS = _CONV_KEYS + ("use_1x1conv", "norm_type", "alpha_init", "return_nmd")
_ACT_LAYERS = ("activation", "relu", "gelu", "sigmoid", "softmax", "tanh")
_ATTENTION_LAYERS = {
    "transformer_encoder": L.TransformerEncoder,
    "cross_frame_attention": L.CrossFrameAttention,
    "axial_attention": L.AxialAttention,
    "local_attention": L.LocalAttention,
}


def _sub(cfg: dict, keys: Sequence[str]) -> dict:
    return {k: cfg[k] for k in keys if k in cfg}


# --- mask-bounded program analysis (copied) --------------------------------

#: layers after the cut must treat an all-true mask identically to None
_MASK_CUT_SAFE_AFTER = frozenset((
    "masked_conv1d", "conv1d", "residual_block", "masked_dyt", "nmd",
    "activation", "relu", "gelu", "sigmoid", "softmax", "tanh", "dropout",
    "dense", "masked_batchnorm", "batchnorm", "crop",
))
_MASK_CUT_SAFE_POOLERS = frozenset((
    "max", "average", "max1d", "average1d", "masked_max", "masked_average",
    "last", "masked_last", "gatedframe",
))


def _conv_shrinks(cfg: dict, default_padding: str) -> tuple[int, int] | None:
    """(interior_shrink, edge_shrink) of one any-mode masked conv, or
    None when unsupported."""
    if not cfg.get("use_masking", True):
        return 0, 0
    if cfg.get("mask_mode", "any") != "any":
        return None
    if cfg.get("strides", 1) != 1:
        return None
    pad = str(cfg.get("padding", default_padding)).lower()
    if pad not in ("same", "valid"):
        return None
    k = int(cfg.get("kernel_size", 3))
    d = int(cfg.get("dilation_rate", 1))
    span1 = d * (k - 1)
    if pad == "same":
        return span1, span1 // 2
    return span1, 0


def mask_cut_plan(rep_cfg: dict) -> list[tuple[object, int, int]] | None:
    """Candidate cuts for the bounded-mask program, or None when the
    architecture doesn't support it.

    Returns ``[(cut_spec, interior_bound, edge_bound), ...]`` ordered
    earliest-cut first; ``cut_spec`` is a rep-learner layer index (mask
    dropped from that layer on) or ``(index, "conv1")`` (the cut right
    after the first residual block's first conv).
    """
    layers = _freeze_layers(rep_cfg.get("hidden_layers", []))
    pooling = rep_cfg.get("pooling")
    if "branch" in rep_cfg or not layers:
        return None
    if pooling is not None and pooling.lower() not in _MASK_CUT_SAFE_POOLERS:
        return None
    interior = 0
    edge = 0
    plans: list[tuple[object, int, int]] = []
    done = False
    for i, (name, cfg) in enumerate(layers):
        if not done:
            if name in ("masked_conv1d", "conv1d"):
                use_mask = cfg.get("use_masking", name == "masked_conv1d")
                s = _conv_shrinks(dict(cfg, use_masking=use_mask),
                                  default_padding="valid")
                if s is None:
                    return None
                interior += s[0]
                edge += s[1]
            elif name == "residual_block":
                s = _conv_shrinks(cfg, default_padding="same")
                if s is None or not cfg.get("use_masking", True) or \
                        cfg.get("return_nmd", False):
                    return None
                if interior + s[0] > 0:
                    plans.append(((i, "conv1"),
                                  interior + s[0], edge + s[1]))
                n_convs = 2 * int(cfg.get("block_size", 1))
                interior += n_convs * s[0]
                edge += n_convs * s[1]
                plans.append((i + 1, interior, edge))
                done = True
            elif name in ("nmd", "masked_dyt", "activation", "relu", "gelu",
                          "sigmoid", "softmax", "tanh", "dropout",
                          "masked_batchnorm", "batchnorm"):
                pass  # mask-preserving
            else:
                return None
        else:
            if name not in _MASK_CUT_SAFE_AFTER:
                return None
            if cfg.get("return_nmd", False):
                return None
    if not done or not plans:
        return None
    return [p for p in plans if p[1] > 0]


def _resolve_crop_nt(sp: dict, input_type: str = "translated") -> int:
    """Nucleotide crop for a string-processor config (largest of a
    ``crop_sizes`` list; nucleotide models use ``crop_size`` in nt)."""
    if sp.get("crop_size") is None and sp.get("crop_sizes"):
        sp = dict(sp, crop_size=max(sp["crop_sizes"]))
    if input_type == "nucleotide":
        return int(sp["crop_size"])
    _, nt = crop_contract.resolve_crop(sp)
    return nt


def _freeze_layers(hidden_layers: list) -> tuple:
    out = []
    for entry in hidden_layers:
        out.append((entry.get("name", "").lower(), dict(entry.get("config") or {})))
    return tuple(out)


_MERGES = ("concat", "sum", "average", "max")


def _merge(outs: list, method: str) -> torch.Tensor:
    """Branch outputs merged by ``method`` (one of ``_MERGES``)."""
    if method == "concat":
        return torch.cat(outs, dim=-1)
    if method == "sum":
        return sum(outs)
    if method == "average":
        return sum(outs) / len(outs)
    return torch.amax(torch.stack(outs, 0), dim=0)


def apply_masking_gate(config: dict) -> dict:
    """The model-level ``use_masking`` gate (JAX ``ModelBuilder.__init__``):
    every layer config inherits ``model.use_masking`` as its default.
    Edits ``config`` in place and returns its model section."""
    model_cfg = config.get("model", config)
    if "use_masking" in model_cfg:
        gate = bool(model_cfg["use_masking"])
        for section in ("representation_learner", "classifier",
                        "projection", "reliability_model"):
            sec = model_cfg.get(section) or {}
            for group in (sec.get("hidden_layers") or [],
                          (sec.get("branch") or {}).get(
                              "hidden_layers") or []):
                for layer in group:
                    layer.setdefault("config", {})
                    layer["config"].setdefault("use_masking", gate)
    return model_cfg


def _remat(module: nn.Module, *args, **kw):
    """``module(*args, **kw)`` under ``torch.utils.checkpoint``: only the
    inputs stay alive for the backward, which runs the module again. The
    rerun draws the same dropout masks (the ``generator`` keyword is set
    back to its state before the first run, then restored) and leaves the
    module's buffers (batch-norm and NMD moving statistics) as the first
    run left them, as JAX's ``nn.remat`` does."""
    generator = kw.get("generator")
    gen_state = None if generator is None else generator.get_state()
    ran = []

    def run(*a):
        if not ran:
            ran.append(True)
            return module(*a, **kw)
        buffers = list(module.buffers())
        saved = [b.clone() for b in buffers]
        after = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(gen_state)
        try:
            return module(*a, **kw)
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)
            if generator is not None:
                generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class LayerStack(nn.Module):
    """A configured stack of zoo layers with NMD collection and pooling.

    Submodules are registered as ``<name>_<index>`` like the flax stack's
    (a ``parallel_branches`` layer's stacks as
    ``<name>_<index>_branch_<b>``, a gated pooler as
    ``global_<pooling>pool``). ``out_channels`` is the feature width after
    the stack, ``nmd_width`` the width of the merged NMD vector (0 without
    NMD taps). ``remat``: residual stacks and Hyena blocks recompute in the
    backward of a training forward (:func:`_remat`). ``seq_axis``: the
    Hyena blocks run length-sharded over the ambient mesh of that axis.
    """

    def __init__(self, layer_configs: tuple, in_channels: int,
                 pooling: str | None = None, nmd_merge: dict | None = None,
                 dtype=torch.float32, remat: bool = False,
                 seq_axis: str | None = None):
        super().__init__()
        self.layer_configs = layer_configs
        self.pooling = pooling
        self.dtype = dtype
        self.remat = bool(remat)
        if pooling is not None and pooling.lower() not in L.POOLERS:
            raise ValueError(f"unknown pooling {pooling!r}")
        c = int(in_channels)
        nmd_widths: list[int] = []
        for i, (name, cfg) in enumerate(layer_configs):
            lname = f"{name}_{i}"
            if name in ("masked_conv1d", "conv1d"):
                kw = _sub(cfg, _CONV_KEYS)
                if name == "conv1d":
                    kw.setdefault("use_masking", False)
                mod = L.MaskedConv1D(c, dtype=dtype, **kw)
                c = mod.filters
            elif name == "multi_scale_conv":
                mod = L.MultiScaleConv1D(
                    c, branches=tuple(cfg.get("branches", [])),
                    merge=cfg.get("merge", "concat"),
                    use_bias=cfg.get("use_bias", True),
                    use_masking=cfg.get("use_masking", True), dtype=dtype)
                c = mod.out_channels
            elif name in ("masked_batchnorm", "batchnorm"):
                mod = L.MaskedBatchNorm(
                    c, epsilon=cfg.get("epsilon", 1e-5),
                    momentum=cfg.get("momentum", 0.9),
                    return_nmd=cfg.get("return_nmd", False),
                    use_masking=cfg.get("use_masking",
                                        name == "masked_batchnorm"))
                if mod.return_nmd:
                    nmd_widths.append(c)
            elif name == "masked_layernorm":
                mod = L.MaskedLayerNorm(c)
            elif name == "layernorm":
                mod = L.LayerNorm(c)
            elif name == "masked_dyt":
                mod = L.MaskedDYT(c, alpha_init=cfg.get("alpha_init", 0.5))
            elif name == "residual_block":
                mod = L.ResidualBlockStack(
                    c, block_size=cfg.get("block_size", 1), dtype=dtype,
                    **_sub(cfg, _RES_KEYS))
                c = int(cfg["filters"])
                if mod.return_nmd:
                    nmd_widths.append(c)
            elif name in _ATTENTION_LAYERS:
                args = (c, cfg["embed_dim"], cfg["num_heads"],
                        cfg["feed_forward_dim"])
                kw = dict(dropout_rate=cfg.get("dropout_rate", 0.1),
                          dtype=dtype)
                if name == "cross_frame_attention":
                    kw["use_ffn"] = cfg.get("use_ffn", True)
                elif name == "axial_attention":
                    kw.update(num_blocks=cfg.get("num_blocks", 1),
                              norm_type=cfg.get("norm_type", "layernorm"),
                              alpha_init=cfg.get("alpha_init", 0.5))
                elif name == "local_attention":
                    kw.update(window_size=cfg["window_size"],
                              num_blocks=cfg.get("num_blocks", 1))
                mod = _ATTENTION_LAYERS[name](*args, **kw)
                c = int(cfg["embed_dim"])
            elif name == "masked_bilstm":
                mod = L.MaskedBiLSTM(
                    c, cfg.get("units", 64),
                    return_sequences=cfg.get("return_sequences", True),
                    ignore_mask=cfg.get("ignore_mask", False), dtype=dtype)
                c = 2 * mod.units
            elif name == "hyena_block":
                mod = L.HyenaBlock(
                    c, cfg["dim"], order=cfg.get("order", 2),
                    filter_hidden=cfg.get("filter_hidden", 32),
                    filter_layers=cfg.get("filter_layers", 2),
                    filter_activation=cfg.get("filter_activation", "gelu"),
                    dropout=cfg.get("dropout", 0.0),
                    output_projection=cfg.get("output_projection", False),
                    filter_normalize=cfg.get("filter_normalize", False),
                    dtype=dtype, seq_axis=seq_axis)
                c = int(cfg["dim"])
            elif name == "parallel_branches":
                merge = cfg.get("merge", "concat").lower()
                if merge not in _MERGES:
                    raise ValueError(f"unknown branch merge {merge!r}")
                widths = []
                for b, bcfg in enumerate(cfg.get("branches", [])):
                    sub = LayerStack(
                        _freeze_layers(bcfg.get("hidden_layers", [])), c,
                        pooling=bcfg.get("pooling"), dtype=dtype)
                    self.add_module(f"{lname}_branch_{b}", sub)
                    widths.append(sub.out_channels)
                c = sum(widths) if merge == "concat" else widths[0]
                continue
            elif name == "nmd":
                mod = L.NMDLayer(c, momentum=cfg.get("momentum", 0.9))
                nmd_widths.append(c)
            elif name == "dense":
                dt = (torch.float32 if str(cfg.get("dtype", "")) == "float32"
                      else dtype)
                mod = L.Dense(c, cfg["units"],
                              use_bias=cfg.get("use_bias", True), dtype=dt)
                c = int(cfg["units"])
            elif name in _ACT_LAYERS or name in ("dropout", "crop"):
                continue
            else:
                raise ValueError(f"unknown layer type: {name}")
            self.add_module(lname, mod)
        if pooling is not None and "gated" in pooling.lower():
            self.add_module(f"global_{pooling}pool",
                            L.GatedFrameGlobalMaxPooling(c, dtype=dtype))
        self.out_channels = c
        self.nmd_merge = None
        self.nmd_width = 0
        if len(nmd_widths) == 1:
            self.nmd_width = nmd_widths[0]
        elif nmd_widths and nmd_merge:
            mm = dict(nmd_merge)
            self.nmd_merge = L.NMDMerge(
                nmd_widths, mode=mm.get("mode", "concat"),
                target_dim=mm.get("target_dim"), dtype=dtype)
            self.nmd_width = self.nmd_merge.out_features
        elif nmd_widths:
            self.nmd_width = sum(nmd_widths)

    def forward(self, x, mask=None, fold_table=None, mask_until=None,
                train: bool = False, taps: bool = True, generator=None):
        """-> (x, mask, nmd, gate). ``mask_until`` drops the mask from that
        layer index on, or inside the first residual block right after its
        conv1 for ``(index, "conv1")`` (the engine's bounded program).
        ``train``: batch statistics, dropout from ``generator``, the fused
        convs' backward. ``taps=False`` skips the NMD taps (heads that do
        not read them). ``gate`` is a gated pooler's ``(B, F)`` gates, or
        None."""
        nmds: list = []
        post_cut = False
        inner_at = cut_at = None
        remat = self.remat and train and torch.is_grad_enabled()
        if mask_until is not None:
            if isinstance(mask_until, (tuple, list)):
                inner_at = int(mask_until[0])
                cut_at = inner_at + 1
            else:
                cut_at = int(mask_until)
        for i, (name, cfg) in enumerate(self.layer_configs):
            if cut_at is not None and i == cut_at:
                # the mask is provably all-true here (engine's run check)
                mask = None
                post_cut = True
            with span("model/activation" if name in _ACT_LAYERS
                      else f"model/{name}"):
                mod = getattr(self, f"{name}_{i}", None)
                if name in ("masked_conv1d", "conv1d"):
                    x, mask = mod(x, mask, fold_table=fold_table if i == 0
                                  else None)
                elif name == "multi_scale_conv":
                    x, mask = mod(x, mask)
                elif name in ("masked_batchnorm", "batchnorm"):
                    bn_mask = mask
                    if (post_cut and mask is None and mod.use_masking
                            and (train or mod.return_nmd)):
                        # the masked statistics under an all-true mask, as the
                        # masked program computes them
                        bn_mask = torch.ones(x.shape[:-1], dtype=torch.bool,
                                             device=x.device)
                    out = mod(x, bn_mask, train)
                    x = out[0]
                    if mod.return_nmd and taps:
                        nmds.append(out[2])
                elif name in ("masked_dyt", "masked_layernorm", "layernorm"):
                    x, mask = mod(x, mask)
                elif name == "residual_block":
                    kw = dict(drop_mask_after_first_conv1=(i == inner_at),
                              train=train, bn_stats_all_true=post_cut)
                    out = (_remat(mod, x, mask, **kw) if remat
                           else mod(x, mask, **kw))
                    x, mask = out[0], out[1]
                    if mod.return_nmd and taps:
                        nmds.append(out[2])
                elif name in _ATTENTION_LAYERS:
                    x, mask = mod(x, mask, train=train, generator=generator)
                elif name == "masked_bilstm":
                    x, mask = mod(x, mask, train=train)
                elif name == "hyena_block":
                    kw = dict(train=train, generator=generator)
                    x, mask = (_remat(mod, x, mask, **kw) if remat
                               else mod(x, mask, **kw))
                elif name == "parallel_branches":
                    x = _merge([getattr(self, f"{name}_{i}_branch_{b}")(
                                    x, mask, train=train, generator=generator)[0]
                                for b in range(len(cfg.get("branches", [])))],
                               cfg.get("merge", "concat").lower())
                    mask = None
                elif name == "nmd":
                    if not taps:
                        continue
                    nmd_mask = mask
                    if post_cut and mask is None:
                        # post-cut taps keep the masked statistics (their
                        # eps-carrying denominators) under an all-true mask
                        nmd_mask = torch.ones(x.shape[:-1], dtype=torch.bool,
                                              device=x.device)
                    nmds.append(mod(x, nmd_mask, train))
                elif name == "dense":
                    x = L.get_activation(cfg.get("activation"))(mod(x))
                elif name in _ACT_LAYERS:
                    act = cfg.get("activation", name if name != "activation"
                                  else None)
                    x = L.get_activation(act)(x)
                elif name == "crop":
                    (t, b_), (l_, r_) = cfg.get("cropping", ((0, 0), (0, 0)))
                    x = x[:, t: x.shape[1] - b_ or None,
                          l_: x.shape[2] - r_ or None, :]
                    if mask is not None:
                        mask = mask[:, t: mask.shape[1] - b_ or None,
                                    l_: mask.shape[2] - r_ or None]
                elif name == "dropout" and train:
                    x = L.dropout(x, float(cfg.get("rate", 0.5)), generator)

        merged_nmd = None
        if len(nmds) == 1:
            merged_nmd = nmds[0]
        elif nmds:
            with span("model/nmd"):
                merged_nmd = (self.nmd_merge(nmds) if self.nmd_merge is not None
                              else torch.cat(nmds, dim=-1))

        gate = None
        if self.pooling is not None:
            with span("model/pooling"):
                if "gated" in self.pooling.lower():
                    x, gate = getattr(self, f"global_{self.pooling}pool")(x, mask)
                else:
                    x, _ = L.POOLERS[self.pooling.lower()](x, mask)
            mask = None
        return x, mask, merged_nmd, gate


class JaegerModel(nn.Module):
    """The fragment model: encode -> embed -> rep learner -> heads.

    ``forward(bases, lengths)`` returns a dict with ``prediction``
    (classifier logits), ``embedding`` (pooled representation), ``nmd``,
    ``gate`` (a gated pooler's frame gates) and ``reliability`` where
    configured; ``projection`` (the self-supervised pretraining head over
    the pooled representation) where configured and asked for
    (``with_projection=True`` or ``"projection"`` in ``heads``).
    ``assume_dense=True`` skips the mask (exact only when every
    window fills the crop with unambiguous bases); ``mask_layers`` selects
    the bounded-mask program (see :func:`mask_cut_plan`).

    Inputs: ``input_type`` ``translated`` (six frames of codon tokens),
    ``nucleotide`` (the two strands one-hot, ``ops/encode.py::
    encode_nucleotide``) or ``both`` (the translated path; JAX encodes the
    nucleotide features too but no layer reads them). A ``branch``
    representation learner applies one shared stack (``rep_branch``) to
    each frame or strand and concatenates the results; a ``branch``
    classifier applies one shared head (``classifier_branch``) to each and
    merges the logits (``average``, ``sum``, ``max`` or ``concat``).
    Reliability mode ``nmd_plus_signals`` feeds the NMD vector and the
    ``OODSignalLayer`` signals of the logits to the reliability head.
    """

    def __init__(self, config: dict, dtype=torch.float32):
        super().__init__()
        cfg = config.get("model", config)
        self.config = cfg
        self.dtype = dtype
        emb_cfg = cfg.get("embedding", {})
        sp = cfg.get("string_processor", {})
        rep_cfg = cfg.get("representation_learner", {})
        self.input_type = emb_cfg.get("input_type", "translated")
        if self.input_type not in ("translated", "nucleotide", "both"):
            raise ValueError(f"invalid input_type {self.input_type!r}")
        self.pos_embedding = None
        if emb_cfg.get("use_positional_embeddings", False):
            self.pos_embedding = L.SinusoidalPositionEmbedding(
                emb_cfg.get("positional_embedding_length", 10000))
        rel_cfg = cfg.get("reliability_model")
        self.rel_mode = (rel_cfg or {}).get("mode", "nmd")
        if rel_cfg and self.rel_mode not in ("nmd", "nmd_plus_signals"):
            raise ValueError(f"unknown reliability mode {self.rel_mode!r}")

        self.alphabet = str(sp.get("codon", "CODON"))
        self.masking = bool(sp.get("masking", False))
        _, ids = maps.resolve_alphabet(self.alphabet)
        self.depth = maps.alphabet_depth(ids)
        self.emb_size = int(emb_cfg.get("embedding_size", 4))
        self.use_embedding_layer = bool(emb_cfg.get("use_embedding_layer",
                                                    False))
        vocab = int(emb_cfg.get("vocab_size", self.depth + 1))
        hidden = rep_cfg.get("hidden_layers", [])
        self.branched = "branch" in rep_cfg
        translated = self.input_type in ("translated", "both")
        # bf16 only: fold the linear embedding into the entry conv
        self.can_fold = (
            translated and self.use_embedding_layer and self.emb_size > 0
            and self.pos_embedding is None and not self.branched
            and bool(hidden)
            and hidden[0].get("name") in ("masked_conv1d", "conv1d")
            and dtype == torch.bfloat16
        )
        if not translated:
            width = 4                                   # A, G, C, T
        elif self.emb_size > 0 and self.use_embedding_layer:
            self.embedding = L.OneHotEmbed(vocab, self.emb_size, dtype=dtype)
            width = self.emb_size
        elif self.emb_size > 0:
            self.translated_embedding = L.Dense(self.depth, self.emb_size,
                                                use_bias=False, dtype=dtype)
            width = self.emb_size
        else:
            width = self.depth

        merge_cfg = (rel_cfg or {}).get("merge")
        rep_kw = dict(dtype=dtype, remat=bool(cfg.get("remat", False)),
                      seq_axis=(cfg.get("parallel") or {}).get("seq_axis"))
        if self.branched:
            bcfg = rep_cfg["branch"]
            self.rep_branch = LayerStack(
                _freeze_layers(bcfg.get("hidden_layers", [])), width,
                pooling=bcfg.get("pooling"), **rep_kw)
            branch_width = self.rep_branch.out_channels
            # one branch per reading frame, or per strand
            rep_width = (6 if translated else 2) * branch_width
            nmd_width = 0
        else:
            self.rep = LayerStack(
                _freeze_layers(hidden), width, pooling=rep_cfg.get("pooling"),
                nmd_merge=merge_cfg, **rep_kw)
            branch_width = rep_width = self.rep.out_channels
            nmd_width = self.rep.nmd_width

        class_cfg = cfg.get("classifier")
        self.classifier = None
        self.classifier_branch = None
        if class_cfg and "branch" in class_cfg:
            hidden_c = list(class_cfg["branch"].get("hidden_layers", []))
            if not hidden_c or hidden_c[-1].get("name") != "merge":
                raise ValueError("branched classifier must end with 'merge'")
            self.class_merge = (hidden_c[-1].get("config") or {}).get(
                "method", "average").lower()
            if self.class_merge not in _MERGES:
                raise ValueError(
                    f"unknown merge method {self.class_merge!r}")
            self.classifier_branch = LayerStack(
                _freeze_layers(hidden_c[:-1]),
                branch_width if self.branched else rep_width, dtype=dtype)
        elif class_cfg:
            self.classifier = LayerStack(
                _freeze_layers(class_cfg.get("hidden_layers", [])),
                rep_width, dtype=dtype)
        proj_cfg = cfg.get("projection")
        self.projection = None
        if proj_cfg:
            self.projection = LayerStack(
                _freeze_layers(proj_cfg.get("hidden_layers", [])),
                rep_width, dtype=dtype)
        self.reliability = None
        if rel_cfg:
            if nmd_width == 0:
                raise ValueError(
                    "reliability_model is configured but the representation "
                    "learner produced no NMD tensor. Add an `nmd` layer or "
                    "set return_nmd: true on a layer that supports it.")
            rel_width = nmd_width
            if self.rel_mode == "nmd_plus_signals":
                self.ood_signals = L.OODSignalLayer(tuple(rel_cfg.get(
                    "signals", ("max_prob", "entropy", "energy", "margin",
                                "nmd_norm"))))
                rel_width += len(self.ood_signals.signals)
            expected = rel_cfg.get("input_shape")
            if expected is not None and int(expected) != rel_width:
                raise ValueError(
                    f"reliability_model.input_shape ({expected}) does not "
                    f"match the computed reliability input dimension "
                    f"({rel_width}). Set input_shape to None or omit it "
                    f"when using mode={self.rel_mode!r}.")
            self.reliability = LayerStack(
                _freeze_layers(rel_cfg.get("hidden_layers", [])), rel_width,
                dtype=dtype)

    @property
    def crop_nt(self) -> int:
        return _resolve_crop_nt(self.config.get("string_processor", {}),
                                self.input_type)

    @property
    def masking_enabled(self) -> bool:
        """Whether soft-masked bases encode as masked tokens."""
        return self.masking

    def _inputs(self, bases, lengths, tokens, frame_perm, assume_dense):
        """-> (x, mask, fold_table): the stack's input."""
        if self.input_type == "nucleotide":
            x = encode.encode_nucleotide(
                bases, lengths, crop_size=min(self.crop_nt, bases.shape[1]),
                masking=self.masking).to(self.dtype)
            mask = None if assume_dense else torch.any(x != 0, dim=-1)
            return x, mask, None
        if tokens is None:
            tokens = encode.encode_frames(
                bases, lengths, crop_size=self.crop_nt, masking=self.masking,
                alphabet=self.alphabet)
        if frame_perm is not None:
            tokens = torch.gather(tokens, 1, frame_perm.long()[:, :, None]
                                  .expand(-1, -1, tokens.shape[2]))
        mask = None if assume_dense else tokens != 0
        if self.emb_size > 0 and self.use_embedding_layer:
            if self.can_fold:
                return tokens, mask, self.embedding.embedding
            return self.embedding(tokens), mask, None
        onehot = (tokens[..., None] - 1 == torch.arange(
            self.depth, device=tokens.device)).to(self.dtype)
        x = (self.translated_embedding(onehot) if self.emb_size > 0
             else onehot)
        return x, mask, None

    def forward(self, bases: torch.Tensor | None = None,
                lengths: torch.Tensor | None = None,
                assume_dense: bool = False, mask_layers=None, *,
                train: bool = False, with_projection: bool = False,
                heads: tuple | None = None,
                tokens: torch.Tensor | None = None,
                frame_perm: torch.Tensor | None = None,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """``tokens`` (B, 6, L) replaces ``bases``/``lengths`` with
        pre-encoded frames; ``frame_perm`` (B, 6) reorders each example's
        frames (train-time augmentation); ``heads`` limits the outputs
        (None = all) as ``jaeger_tpu/models/builder.py:815-824`` does, and
        the projection head runs only with ``with_projection`` or when
        ``heads`` names it (``:911-922``); ``train`` with ``generator`` for
        dropout."""
        with span("model/encode"):
            x, mask, fold_table = self._inputs(bases, lengths, tokens,
                                               frame_perm, assume_dense)
            if self.pos_embedding is not None:
                x = x + self.pos_embedding(x)
        need_rel = self.reliability is not None and (
            heads is None or "reliability" in heads)
        need_pred = (self.classifier is not None
                     or self.classifier_branch is not None) and (
            heads is None or "prediction" in heads
            or (need_rel and self.rel_mode == "nmd_plus_signals"))
        kw = dict(train=train, generator=generator)
        rep_branches = None
        nmd = gate = None
        if self.branched:
            rep_branches = [
                self.rep_branch(x[:, i: i + 1],
                                None if mask is None else mask[:, i: i + 1],
                                **kw)[0]
                for i in range(x.shape[1])]
            rep = torch.cat(rep_branches, dim=-1)
        else:
            rep, _, nmd, gate = self.rep(x, mask, fold_table=fold_table,
                                         mask_until=mask_layers,
                                         taps=need_rel, **kw)
        outputs = {"embedding": rep}
        if nmd is not None:
            outputs["nmd"] = nmd
        if gate is not None:
            outputs["gate"] = gate
        with span("model/heads"):
            logits = None
            if need_pred and self.classifier_branch is not None:
                logits = _merge([self.classifier_branch(b, **kw)[0]
                                 for b in (rep_branches or [rep])],
                                self.class_merge)
            elif need_pred:
                logits = self.classifier(rep, **kw)[0]
            if logits is not None:
                outputs["prediction"] = logits
            if self.projection is not None and (
                    with_projection or (heads is not None
                                        and "projection" in heads)):
                outputs["projection"] = self.projection(rep, **kw)[0]
            if need_rel:
                rel_in = nmd
                if self.rel_mode == "nmd_plus_signals":
                    rel_in = torch.cat([nmd.float(),
                                        self.ood_signals(logits, nmd)],
                                       dim=-1).to(self.dtype)
                outputs["reliability"] = self.reliability(rel_in, **kw)[0]
        return outputs

    def regularizer_specs(self) -> list[tuple[str, str, float]]:
        """(param-path regex, kind, weight) triples from the config, as
        ``jaeger_tpu/models/builder.py:1031-1069`` collects them; paths are
        flax's, ``/``-joined."""
        specs: list[tuple[str, str, float]] = []
        emb = self.config.get("embedding", {})
        if emb.get("embedding_regularizer"):
            specs.append((r"embedding", str(emb["embedding_regularizer"]),
                          float(emb.get("embedding_regularizer_w", 0.0))))

        def walk(section: str, cfg: dict):
            for i, entry in enumerate(cfg.get("hidden_layers", [])):
                c = entry.get("config") or {}
                if c.get("kernel_regularizer"):
                    name = entry.get("name", "").lower()
                    specs.append(
                        (rf"{section}/.*{re.escape(name)}_{i}.*/kernel",
                         str(c["kernel_regularizer"]),
                         float(c.get("kernel_regularizer_w", 0.0))))

        for section, name in (("representation_learner", "rep"),
                              ("classifier", "classifier"),
                              ("projection", "projection"),
                              ("reliability_model", "reliability")):
            sec_cfg = self.config.get(section) or {}
            walk(name, sec_cfg)
            if "branch" in sec_cfg:
                walk(f"{name}_branch", sec_cfg["branch"])
        return specs


def build_model(config: dict, dtype=torch.float32) -> JaegerModel:
    """A :class:`JaegerModel` with zero weights (load or init them next)."""
    apply_masking_gate(config)
    return JaegerModel(config, dtype=dtype)
