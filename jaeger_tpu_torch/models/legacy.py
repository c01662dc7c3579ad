"""Counterpart of `jaeger_tpu/models/legacy.py`: the legacy model family.

The deprecated ``default`` / ``experimental_*`` models behind ``predict
-m default`` and ``predict-legacy``: six amino-acid token streams through
one dilated convolution tower whose weights all six reading frames share
("RC-CNN"), added together, pooled over the length into dense heads.
Outputs ``{"output", "prediction", "embedding"}`` as the JAX modules do.

Inference only, in f32. Parameters keep the flax names, shapes and
collections (conv kernels ``(k, C_in, C_out)``, dense kernels ``(in,
out)``, batch norms' ``scale`` / ``bias`` parameters and ``mean`` /
``var`` buffers, the embedding ``aa.embedding`` ``(22, 4)``), so
:func:`jaeger_tpu_torch.models.artifacts.params_from_jax` carries a flax
variable tree across (``load_state(model, params_from_jax(variables))``)
and :func:`variables_from_state` writes one back.

The tower runs channels-first ``(N, C, L)``, the layout cuDNN's
``F.conv1d`` takes, with the six frames of a batch stacked along N: each
conv runs once on ``B * 6`` sequences, not six times, and the frames are
then added in JAX's order (``sum(outs)``: frame 0, then + frame 1, ...),
which keeps the f32 sums JAX's. Batch norms are Keras-style (epsilon
1e-3) in flax's inference form ``(x - mean) * (rsqrt(var + eps) *
scale) + bias``; ``gelu`` is the exact erf form; max pools take windows
of 2 at stride 2 with floor lengths; SAME padding with dilation pads
``d (k - 1)`` in all, the smaller half on the left.

No TPU kernel is involved: JAX runs these convs on XLA's ``nn.Conv``, and
the port runs them on cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jaeger_tpu_torch.models.layers import (MHA, Dense, MaskedBiLSTM,
                                            OneHotEmbed, _param, _same_pads)

#: amino vocabulary of the legacy models (21 amino classes + stop, +1
#: shift; token 0 is ambiguous / padding and embeds as row 0)
AA_VOCAB = 22
#: Murphy-10 v2 classes one-hot encoded by the experimental models
MURPHY_DEPTH = 11


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


class Conv(nn.Module):
    """``flax.linen.Conv`` with SAME padding over ``(N, C, L)``: kernel
    ``(k, C_in, C_out)`` and bias, any dilation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size = int(kernel_size)
        self.dilation = int(dilation)
        self.kernel = _param(self.kernel_size, in_channels, features)
        self.bias = _param(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad_l, pad_r = _same_pads(x.shape[-1], self.kernel_size, 1,
                                  self.dilation)
        if pad_l != pad_r:
            x = F.pad(x, (pad_l, pad_r))
            pad_l = 0
        return F.conv1d(x, self.kernel.permute(2, 1, 0), self.bias,
                        padding=pad_l, dilation=self.dilation)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` at inference (Keras epsilon 1e-3) over
    ``axis``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = float(epsilon)
        self.scale = _param(channels)
        self.bias = _param(channels)
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[axis] = -1
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        return ((x - self.mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` (epsilon 1e-6, its fast variance
    ``E[x^2] - E[x]^2``) in f32."""

    def __init__(self, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.scale = _param(channels)
        self.bias = _param(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = torch.mean(x, dim=-1, keepdim=True)
        mean2 = torch.mean(x * x, dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon)
                             * self.scale) + self.bias


def _sum_frames(y: torch.Tensor, frames: int) -> torch.Tensor:
    """``(B * F, ...)`` -> ``(B, ...)``: the frames added in order, as
    Python's ``sum`` over JAX's per-frame outputs."""
    y = y.reshape(-1, frames, *y.shape[1:])
    out = y[:, 0]
    for f in range(1, frames):
        out = out + y[:, f]
    return out


class _SharedConvTower(nn.Module):
    """Dilated conv tower with weights shared over the frames, then the
    frames added (reference ``v1/layers.py:154-208``): ``(B * F, C_in, L)``
    -> ``(B, 128, L // 4)``."""

    def __init__(self, num_res_blocks: int = 5, add_residual: bool = True,
                 filters: int = 128, in_channels: int = 4):
        super().__init__()
        self.num_res_blocks = int(num_res_blocks)
        self.add_residual = bool(add_residual)
        self.block1_0 = Conv(in_channels, filters, 9, 1)
        self.bn1_0 = BatchNorm(filters)
        self.block1_1 = Conv(filters, filters, 5, 2)
        self.bn1_1 = BatchNorm(filters)
        for n in range(self.num_res_blocks):
            self.add_module(f"block2_{n}_a", Conv(filters, filters, 5, 3 + n))
            self.add_module(f"bn2_{n}_a", BatchNorm(filters))
            self.add_module(f"block2_{n}_b", Conv(filters, filters, 5, 3 + n))
            self.add_module(f"bn2_{n}_b", BatchNorm(filters))

    def forward(self, x: torch.Tensor, frames: int = 6) -> torch.Tensor:
        h = self.bn1_0(_gelu(self.block1_0(x)), axis=1)
        h = F.max_pool1d(h, 2, 2)
        h = self.bn1_1(_gelu(self.block1_1(h)), axis=1)
        h = F.max_pool1d(h, 2, 2)
        for n in range(self.num_res_blocks):
            r = getattr(self, f"bn2_{n}_a")(
                _gelu(getattr(self, f"block2_{n}_a")(h)), axis=1)
            r = getattr(self, f"bn2_{n}_b")(
                _gelu(getattr(self, f"block2_{n}_b")(r)), axis=1)
            # rc_resnet_block ends with a gelu: on the residual sum when
            # add_residual, else on the block output
            h = _gelu(h + r) if self.add_residual else _gelu(r)
        return _sum_frames(h, frames)


def _embed_frames(embed: OneHotEmbed, tokens: torch.Tensor) -> torch.Tensor:
    """``(B, F, L)`` amino tokens -> ``(B * F, 4, L)`` f32 embeddings."""
    b, f, length = tokens.shape
    emb = embed(tokens.reshape(b * f, length))              # (B*F, L, 4)
    return emb.transpose(1, 2).contiguous()


class WResModel(nn.Module):
    """Legacy 4-class amino model with the embedding side output
    (``WRes_model_embeddings``, reference ``v1/layers.py:399-424``).
    Input: ``(B, 6, L)`` amino tokens (0 = pad)."""

    def __init__(self, num_classes: int = 4):
        super().__init__()
        self.aa = OneHotEmbed(AA_VOCAB, 4)
        self.tower = _SharedConvTower(num_res_blocks=5, add_residual=False)
        self.add_module("augdense-1", Dense(128, 128))
        self.add_module("augdense-2", Dense(128, 128))
        self.outdense = Dense(128, num_classes)

    def forward(self, tokens: torch.Tensor) -> dict:
        x = self.tower(_embed_frames(self.aa, tokens), tokens.shape[1])
        x = torch.amax(x, dim=-1)                        # GlobalMaxPool1D
        x = _gelu(getattr(self, "augdense-1")(x))
        gmp = _gelu(getattr(self, "augdense-2")(x))
        out = self.outdense(gmp)
        return {"output": out, "prediction": out, "embedding": gmp}


class LSTMModel(nn.Module):
    """Legacy conv tower + BiLSTM classifier (reference
    ``v1/layers.py:427-450``): the tower's output, ``(B, 1, L/4, 128)``,
    through ``MaskedBiLSTM`` (128 units, last state, no mask)."""

    def __init__(self, num_classes: int = 4):
        super().__init__()
        self.aa = OneHotEmbed(AA_VOCAB, 4)
        self.tower = _SharedConvTower(num_res_blocks=5, add_residual=True)
        self.bidirlstm = MaskedBiLSTM(128, 128, return_sequences=False,
                                      ignore_mask=True)
        self.add_module("augdense-1", Dense(256, 128))
        self.add_module("augdense-2", Dense(128, 128))
        self.outdense = Dense(128, num_classes)

    def forward(self, tokens: torch.Tensor) -> dict:
        x = self.tower(_embed_frames(self.aa, tokens), tokens.shape[1])
        seq, _ = self.bidirlstm(x.transpose(1, 2)[:, None], None)
        x = _gelu(getattr(self, "augdense-1")(seq[:, 0]))
        x = _gelu(getattr(self, "augdense-2")(x))
        out = self.outdense(x)
        return {"output": out, "prediction": out}


class Vitra(nn.Module):
    """Legacy ViT-style classifier (reference ``v1/layers.py:450-520``):
    the tower's ``num_patches`` positions as patches, a dense projection
    and a learned positional embedding, ``transformer_layers`` blocks (LN
    -> MHA -> add -> LN -> MLP -> add), a final LN, a global max (or
    average) pool and an MLP head. The attention has flax's
    ``MultiHeadDotProductAttention`` tree: ``qkv_features`` =
    ``projection_dim * num_heads``, ``out_features`` = ``projection_dim``.
    ``num_patches`` is ``L // 4`` for ``L`` codons a frame."""

    def __init__(self, num_patches: int, num_classes: int = 4,
                 transformer_layers: int = 4, num_heads: int = 4,
                 projection_dim: int = 128, att_hidden=(128, 128),
                 mlp_hidden=(128, 128), global_type: str = "max"):
        super().__init__()
        self.transformer_layers = int(transformer_layers)
        self.att_hidden = tuple(att_hidden)
        self.mlp_hidden = tuple(mlp_hidden)
        self.global_type = global_type
        p = int(projection_dim)
        self.aa = OneHotEmbed(AA_VOCAB, 4)
        self.tower = _SharedConvTower(num_res_blocks=5, add_residual=True)
        self.patch_proj = Dense(128, p)
        self.pos_embedding = _param(int(num_patches), p)
        for layer in range(self.transformer_layers):
            self.add_module(f"ln1_{layer}", LayerNorm(p))
            self.add_module(f"mha_{layer}", MHA(
                p, p * int(num_heads), int(num_heads), out_features=p))
            self.add_module(f"ln2_{layer}", LayerNorm(p))
            self._mlp(f"attmlp_{layer}", p, self.att_hidden)
        self.final_ln = LayerNorm(p)
        self._mlp("head", p, self.mlp_hidden)
        self.out = Dense(self.mlp_hidden[-1] if self.mlp_hidden else p,
                         num_classes)

    def _mlp(self, name: str, width: int, units) -> None:
        for i, u in enumerate(units):
            self.add_module(f"{name}_dense_{i}", Dense(width, u))
            width = u

    def _mlp_apply(self, name: str, h: torch.Tensor, units) -> torch.Tensor:
        for i in range(len(units)):
            h = _gelu(getattr(self, f"{name}_dense_{i}")(h))
        return h

    def forward(self, tokens: torch.Tensor) -> dict:
        patches = self.tower(_embed_frames(self.aa, tokens),
                             tokens.shape[1]).transpose(1, 2)  # (B, P, 128)
        x = self.patch_proj(patches) + self.pos_embedding
        for layer in range(self.transformer_layers):
            h1 = getattr(self, f"ln1_{layer}")(x)
            x2 = getattr(self, f"mha_{layer}")(h1) + x
            h3 = getattr(self, f"ln2_{layer}")(x2)
            x = self._mlp_apply(f"attmlp_{layer}", h3, self.att_hidden) + x2
        rep = self.final_ln(x)
        rep = (torch.mean(rep, dim=1) if self.global_type == "average"
               else torch.amax(rep, dim=1))
        logits = self.out(self._mlp_apply("head", rep, self.mlp_hidden))
        return {"output": logits, "prediction": logits}


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


class ExperimentalModel(nn.Module):
    """Legacy v2 ``experimental_*`` classifier (reference
    ``create_jaeger_model``, ``nnlib/v1/layers.py:735-785``, over
    ``ConvolutionalTower_g2``, ``:686-733``): a per-frame conv tower with
    shared weights on Murphy-10 one-hot codons, the frames summed, a
    global average pool, two 32-wide dense + BN stages and a linear head;
    the embedding is the last 32-wide feature. Input: ``(B, 6, L, 11)``
    one-hot, or ``(B, 6, L)`` class IDs from :func:`encode_murphy_windows`.

    Modules are registered in the order flax creates their parameters, so
    :func:`variables_from_state` gives JAX's tree order (the experimental
    ``.h5`` converter's tie-break relies on it)."""

    def __init__(self, num_classes: int = 4, num_res_blocks: int = 10,
                 add_residual: bool = True):
        super().__init__()
        self.num_res_blocks = int(num_res_blocks)
        self.add_residual = bool(add_residual)
        self.conv1 = Conv(MURPHY_DEPTH, 128, 9)
        self.block1_1 = BatchNorm(128)
        self.conv2 = Conv(128, 128, 3, 2)
        self.block1_2 = BatchNorm(128)
        c = 128
        for i in range(self.num_res_blocks):
            self.add_module(f"block2_{i}_1", Conv(c, 256, 3, 3))
            self.add_module(f"block2_{i}_1_norm", BatchNorm(256))
            if self.add_residual and c != 256:
                self.add_module(f"block2_{i}_skip", Conv(c, 256, 1))
                self.add_module(f"block2_{i}_skip_norm", BatchNorm(256))
            self.add_module(f"block2_{i}_3", Conv(256, 256, 3, 3))
            self.add_module(f"block2_{i}_3_norm", BatchNorm(256))
            c = 256
        self.sum_reduce_norm = BatchNorm(c)
        self.add_module("augdense-1", Dense(c, 32))
        self.dense1 = BatchNorm(32)
        self.add_module("augdense-2", Dense(32, 32))
        self.dense2 = BatchNorm(32)
        self.outdense = Dense(32, num_classes)

    def forward(self, x: torch.Tensor) -> dict:
        if x.dim() == 3:  # class IDs -> one-hot depth 11
            x = F.one_hot(x.long(), MURPHY_DEPTH).float()
        b, f, length, depth = x.shape
        h = x.reshape(b * f, length, depth).float().transpose(1, 2)
        h = F.max_pool1d(self.conv1(h), 2, 2)
        h = _leaky(self.block1_1(h, axis=1))
        h = _leaky(self.block1_2(self.conv2(h), axis=1))
        for i in range(self.num_res_blocks):
            m = lambda name: getattr(self, f"block2_{i}_{name}")  # noqa: E731
            xx = F.relu(m("1_norm")(m("1")(h), axis=1))
            skip = h
            if self.add_residual and hasattr(self, f"block2_{i}_skip"):
                skip = _leaky(m("skip_norm")(m("skip")(h), axis=1))
            xx = _leaky(m("3_norm")(m("3")(xx), axis=1))
            h = skip + xx if self.add_residual else xx
        h = h.reshape(b, f, *h.shape[1:]).sum(dim=1)       # SumReduce
        h = torch.mean(self.sum_reduce_norm(h, axis=1), dim=-1)
        h = self.dense1(F.relu(getattr(self, "augdense-1")(h)))
        x1 = self.dense2(F.relu(getattr(self, "augdense-2")(h)))
        out = self.outdense(x1)
        return {"output": out, "prediction": out, "embedding": x1}


def encode_amino_windows(bases: torch.Tensor, lengths: torch.Tensor,
                         crop_size: int) -> torch.Tensor:
    """(B, >=crop) base IDs -> (B, 6, K) amino tokens for the legacy
    models: the v1 preprocessor's ``AA_V1`` numbering, with ``masking``
    on (a codon touching a soft-masked or ambiguous base is token 0)."""
    from jaeger_tpu_torch.ops.encode import encode_frames

    return encode_frames(bases, lengths, crop_size=crop_size, masking=True,
                         alphabet="AA_V1")


def encode_murphy_windows(bases: torch.Tensor, lengths: torch.Tensor,
                          crop_size: int) -> torch.Tensor:
    """(B, >=crop) base IDs -> (B, 6, K) legacy-v2 Murphy-10 class IDs:
    ``MURPHY10_V2`` with ``masking`` on, then ``max(t - 1, 0)`` (unknown,
    soft-masked and stop codons share class 0)."""
    from jaeger_tpu_torch.ops.encode import encode_frames

    t = encode_frames(bases, lengths, crop_size=crop_size, masking=True,
                      alphabet="MURPHY10_V2")
    return torch.clamp_min(t - 1, 0)


def variables_from_state(model: nn.Module) -> dict:
    """The inverse of ``params_from_jax``: ``{"params", "batch_stats"}``
    nested dicts of f32 numpy arrays, parameters under ``params`` and
    buffers under ``batch_stats``, in the model's registration order."""
    tree: dict = {"params": {}, "batch_stats": {}}
    buffers = {k for k, _ in model.named_buffers()}
    for key, t in model.state_dict().items():
        node = tree["batch_stats" if key in buffers else "params"]
        *scopes, leaf = key.split(".")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = t.detach().cpu().float().numpy()
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree
