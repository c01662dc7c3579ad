"""Counterpart of `jaeger_tpu/parallel/hyena_sp.py`: sequence-sharded Hyena.

A full-contig Hyena model's activations (order + 1 projection streams of
the whole length) are its memory wall. This module shards the **length**
axis over a :class:`~jaeger_tpu_torch.parallel.mesh.DeviceMesh`: each
device holds one chunk of ``S = L / n`` positions of every stream, and the
causal long convolution streams source chunks around a ring in chunked
overlap-save form, so each device holds one travelling chunk at a time,
never the gathered stream.

Math (JAX's): device ``i``'s output chunk is ``y_i[t] = Σ_{k=0..i}
C_k(z_{i-k})[t]``, where the block contribution ``C_k(x)[t] = Σ_s x[s] ·
h[kS + t - s]`` is a linear convolution of the S-chunk with the 2S-1
filter segment ``g_k = h[kS-S+1 .. kS+S-1]`` (zero outside [0, L); k = 0's
negative taps are the causality guard). The ring moves each chunk one hop
a step (a ``.to(next device)`` copy, JAX's ``ppermute``); step ``k`` adds
``C_k`` of the travelling chunk on the devices with ``i >= k`` (JAX's
``me >= k`` mask: the other devices add nothing).

Block contributions dispatch on dtype as JAX's do: bf16 takes the banded
Toeplitz product when the (D, S, S) operator fits
``_DIRECT_CONV_MAX_L`` / ``_DIRECT_CONV_MAX_BYTES`` (the port's
``models/layers.py`` constants, read at call time), everything else the
f32 FFT at length 3S - 2. Every step is a differentiable torch op, so
training runs through the ring by autograd.

The port keeps its Hyena operator's ``(B, D, L)`` stream layout: the
functions take and return ``(B, D, ·)`` tensors where JAX's take
``(B, S, D)`` projections; a sharded stream is a list of chunks, chunk
``i`` on ``mesh.devices[i]``.
"""

from __future__ import annotations

import torch

from jaeger_tpu_torch.models import layers as L


def _filter_segments(h: torch.Tensor, n_chunks: int, S: int) -> torch.Tensor:
    """(D, L) full filters -> (n_chunks, D, 2S-1) block segments.

    Segment k covers taps ``kS-S+1 .. kS+S-1`` with zeros outside the
    causal [0, L) range.
    """
    D, length = h.shape
    u = torch.arange(2 * S - 1, device=h.device)
    k = torch.arange(n_chunks, device=h.device)
    idx = k[:, None] * S - (S - 1) + u[None, :]           # (n, 2S-1)
    valid = (idx >= 0) & (idx < length)
    g = h[:, idx.clamp(0, length - 1)]                    # (D, n, 2S-1)
    g = torch.where(valid[None], g, torch.zeros((), dtype=h.dtype,
                                                device=h.device))
    return g.permute(1, 0, 2)                             # (n, D, 2S-1)


def _block_contrib_fft(x32: torch.Tensor, g32: torch.Tensor) -> torch.Tensor:
    """C_k via FFT: x (B, D, S) chunk, g (D, 2S-1) segment -> (B, D, S):
    the full linear convolution at output lags S-1 .. 2S-2."""
    S = x32.shape[-1]
    n = 3 * S - 2
    X = torch.fft.rfft(x32, n=n, dim=-1)
    G = torch.fft.rfft(g32, n=n, dim=-1)
    y = torch.fft.irfft(X * G[None], n=n, dim=-1)
    return y[..., S - 1:2 * S - 1]


def _block_contrib_toeplitz(x32: torch.Tensor, g32: torch.Tensor):
    """C_k as a banded-Toeplitz product: T[d, t, s] = g[d, t - s + S - 1]."""
    S = x32.shape[-1]
    ar = torch.arange(S, device=x32.device)
    lag = ar[:, None] - ar[None, :] + (S - 1)
    T = g32[:, lag]                                       # (D, S, S)
    return torch.einsum("dts,bds->bdt", T, x32)


def _block_contrib(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    orig = x.dtype
    x32, g32 = x.float(), g.float()
    S = x.shape[-1]
    if (orig == torch.bfloat16 and S <= L._DIRECT_CONV_MAX_L
            and g.shape[0] * S * S * 4 <= L._DIRECT_CONV_MAX_BYTES):
        return _block_contrib_toeplitz(x32, g32).to(orig)
    return _block_contrib_fft(x32, g32).to(orig)


def ring_causal_conv(chunks: list, h: torch.Tensor, mesh) -> list:
    """The full-length causal convolution of a sharded ``(B, D, L)``
    stream with ``(D, L)`` filters: ``chunks[i]`` ``(B, D, S)`` on
    ``mesh.devices[i]`` -> the output chunks, likewise placed.

    Chunked overlap-save on a ring: step k convolves the chunk that
    started k hops upstream with filter segment k on the devices whose
    chunk index is >= k; then every chunk moves one hop on."""
    n = mesh.size
    S = chunks[0].shape[-1]
    segs = mesh.replicate(_filter_segments(h, n, S))
    buf = list(chunks)
    acc = [None] * n
    for k in range(n):
        for i in range(n):
            if i >= k:
                contrib = _block_contrib(buf[i], segs[i][k])
                acc[i] = contrib if acc[i] is None else acc[i] + contrib
        if k + 1 < n:
            # ppermute i -> i + 1 (mod n)
            buf = [buf[(i - 1) % n].to(mesh.devices[i]) for i in range(n)]
    return acc


def gathered_causal_conv(chunks: list, h: torch.Tensor, mesh) -> list:
    """The oracle the ring is held against: gather the full stream,
    convolve it whole (``causal_fft_convolve``), cut it back into chunks."""
    full = mesh.gather(chunks, dim=-1, device=h.device)
    return mesh.shard_along(L.causal_fft_convolve(full, h), dim=-1)


def hyena_recurrence_sp(projections: list, filters: torch.Tensor,
                        mesh) -> torch.Tensor:
    """The order-N gated recurrence ``z <- ring_conv(z, h_i) * gate_i`` on
    length shards.

    ``projections``: order + 1 full ``(B, D, L)`` streams, L a multiple of
    ``mesh.size``; ``filters``: ``(order, D, L)``. Each stream is cut into
    one chunk a device; the gates multiply on their chunk's device; the
    output ``(B, D, L)`` is gathered on the projections' device.
    """
    home = projections[0].device
    z = mesh.shard_along(projections[0], dim=-1)
    for i in range(filters.shape[0]):
        gates = mesh.shard_along(projections[i + 1], dim=-1)
        conv = ring_causal_conv(z, filters[i], mesh)
        z = [c * g for c, g in zip(conv, gates)]
    return mesh.gather(z, dim=-1, device=home)


def sequence_sharded_hyena_op(projections: torch.Tensor,
                              filters: torch.Tensor, mesh) -> torch.Tensor:
    """Convenience wrapper: ``projections`` ``(order+1, B, D, L)``,
    ``filters`` ``(order, D, L)`` -> ``(B, D, L)``."""
    return hyena_recurrence_sp(list(projections.unbind(0)), filters, mesh)
