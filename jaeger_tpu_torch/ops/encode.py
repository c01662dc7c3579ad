"""On-device 6-reading-frame codon encoding (PyTorch).

Counterpart of `jaeger_tpu/ops/encode.py`. The host ships raw base IDs
(nibble-packed, two per byte) and the codon translation — case folding,
reverse complement, trigram->codon mapping, frame slicing, mask tail —
runs on the device as integer arithmetic on the tensors: the classical
codon-table order is a 2-bit permutation of the base IDs, so no table
gather is needed for the CODON alphabet.

Semantics (pinned against the JAX function and its literal oracle by
tests/test_torch_encode.py):

* base IDs A=0 T=1 G=2 C=3 N=4, lowercase (soft-masked) 5-8;
* codon IDs in classical table order, N-containing trigram -> -1;
* every frame yields ``K = ceil((m - 5 + offset)/3)`` valid positions,
  ``offset = [-2,-1,0][crop % 3]``;
* tokens are ``codon_id + 1`` so 0 doubles as pad/ambiguous = masked.

The numpy planners (``pack_bases``, ``dense_window_rows``,
``dense_window_batch``, ``_run_stats``, ``bounded_mask_levels``) are
copies of the JAX module's host code. ``encode_nucleotide`` gives the
nucleotide models' input: the two strands one-hot in A, G, C, T order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from jaeger_tpu_torch.seqops import crop as crop_contract
from jaeger_tpu_torch.seqops import maps


#: base ID (A T G C N) -> one-hot channel in A, G, C, T order; N -> none
_NUC_ID = (0, 3, 1, 2, -1)


@functools.lru_cache(maxsize=8)
def codon_table(alphabet: str = "CODON") -> np.ndarray:
    """Flat (125,) trigram -> codon-class table in base-ID space.

    Index is ``b0*25 + b1*5 + b2``; any trigram containing N maps to -1.
    """
    codons, codon_ids = maps.resolve_alphabet(alphabet)
    bases = "ATGCN"
    lut = np.full(125, -1, dtype=np.int32)
    codon_to_id = {c: i for c, i in zip(codons, codon_ids)}
    for i0 in range(4):
        for i1 in range(4):
            for i2 in range(4):
                tri = bases[i0] + bases[i1] + bases[i2]
                cid = codon_to_id.get(tri)
                if cid is not None:
                    lut[i0 * 25 + i1 * 5 + i2] = cid
    return lut


def frame_positions(crop_size: int) -> int:
    """Static per-frame token count K for a given nucleotide crop."""
    return crop_contract.frame_length(crop_size, crop_size)


def _codon_ids_arith(b: torch.Tensor) -> torch.Tensor:
    """(B, L) int base IDs -> (B, L-2) classical-table codon IDs.

    ``g(b) = ((b & 1) ^ 1) * 2 + (b >> 1)`` maps A0 T1 G2 C3 onto the TCAG
    positions, and the codon ID is ``16*g(b1) + 4*g(b0) + g(b2)``.
    Ambiguous bases (id >= 4) make the codon -1.
    """
    g = ((b & 1) ^ 1) * 2 + (b >> 1)
    b0, b1, b2 = b[:, :-2], b[:, 1:-1], b[:, 2:]
    g0, g1, g2 = g[:, :-2], g[:, 1:-1], g[:, 2:]
    cid = 16 * g1 + 4 * g0 + g2
    valid = (b0 < 4) & (b1 < 4) & (b2 < 4)
    return torch.where(valid, cid, torch.full_like(cid, -1))


def _trigram_codons(b: torch.Tensor, alphabet: str) -> torch.Tensor:
    """(B, L) base IDs -> (B, L-2) codon class IDs (-1 for ambiguous)."""
    cid = _codon_ids_arith(b)
    if alphabet.upper() in ("CODON", "CODON_ID"):
        return cid
    # reduced alphabets remap through a 64-entry table
    _, ids = maps.resolve_alphabet(alphabet)
    lut64 = torch.as_tensor(list(ids), dtype=cid.dtype, device=cid.device)
    return torch.where(cid >= 0, lut64[cid.clamp_min(0)],
                       torch.full_like(cid, -1))


def _frames_from_codons(codons: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L-2) codons -> (B, 3, K) frames via strided slices."""
    f = [codons[:, off::3][:, :k] for off in range(3)]
    # short crops can yield fewer than K positions in a slice
    f = [F.pad(x, (0, k - x.shape[1])) if x.shape[1] < k else x for x in f]
    return torch.stack(f, dim=1)


def dense_window_rows(bases: np.ndarray, lengths: np.ndarray,
                      crop_nt: int,
                      masking_enabled: bool = True) -> np.ndarray:
    """Per-row dense predicate: row i is True when the maskless
    (``assume_dense``) program is exact for window i — it fills the
    model's crop and no base encodes to a masked token. Base IDs: 0-3
    ACGT, 4 N, 5-8 soft-masked lowercase (which encode to their
    uppercase base when the model's ``masking`` flag is off)."""
    if bases.shape[1] < crop_nt:
        return np.zeros(bases.shape[0], bool)
    window = bases[:, :crop_nt]
    ok = np.asarray(lengths) >= crop_nt
    if masking_enabled:
        return ok & (window.max(axis=1) < 4)
    return ok & ~(window == 4).any(axis=1)


def _run_stats(cod: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(interior_max, edge_max) True-run lengths per row of (N, K)."""
    n, K = cod.shape
    cs = np.cumsum(cod, axis=1)
    last = np.maximum.accumulate(np.where(~cod, cs, 0), axis=1)
    runlen = np.where(cod, cs - last, 0)
    has_false = ~cod.all(axis=1)
    lead = np.where(cod[:, 0],
                    np.where(has_false, np.argmin(cod, axis=1), K), 0)
    rev = cod[:, ::-1]
    trail = np.where(cod[:, -1],
                     np.where(has_false, np.argmin(rev, axis=1), K), 0)
    pos = np.arange(K)[None, :]
    interior = np.where(
        (pos >= lead[:, None]) & (pos < K - trail[:, None]), runlen, 0
    ).max(axis=1)
    return interior, np.maximum(lead, trail)


def bounded_mask_levels(bases: np.ndarray, lengths: np.ndarray,
                        crop_nt: int, masking_enabled: bool,
                        plans) -> np.ndarray:
    """Per-row earliest qualifying bounded-mask cut, or -1.

    ``plans`` is ``builder.mask_cut_plan``'s list: row i qualifies for
    plan p when every invalid run not touching a window edge is at most
    ``p[1]`` codons and every edge-touching run at most ``p[2]`` —
    any-mode mask growth then provably clears the mask by that cut.
    Mirrors :func:`encode_frames`' token-0 semantics exactly.
    """
    n = bases.shape[0]
    C = int(crop_nt)
    if bases.shape[1] < C:
        return np.full(n, -1, np.int64)
    b = np.asarray(bases[:, :C])
    m = np.minimum(np.asarray(lengths, np.int64), C)
    if masking_enabled:
        bad = b >= 4
    else:
        bad = b == 4
    pos = np.arange(C)[None, :]
    bad = bad | (pos >= m[:, None])
    K = frame_positions(C)
    offset = crop_contract.OFFSET_LUT[C % 3]
    p_valid = np.maximum(0, -((-(m - 5 + offset)) // 3))
    tail = np.arange(K)[None, :] >= p_valid[:, None]
    # rc stream: reverse of bad over the valid prefix, right-padded True
    idx = m[:, None] - 1 - pos
    rc_bad = np.where(
        idx >= 0, np.take_along_axis(bad, np.clip(idx, 0, C - 1), axis=1),
        True,
    )
    interior = np.zeros(n, np.int64)
    edge = np.zeros(n, np.int64)
    for src in (bad, rc_bad):
        for o in range(3):
            seg = src[:, o:o + 3 * K]
            if seg.shape[1] < 3 * K:
                seg = np.pad(seg, ((0, 0), (0, 3 * K - seg.shape[1])),
                             constant_values=True)
            cod = seg.reshape(n, K, 3).any(axis=2) | tail
            i_max, e_max = _run_stats(cod)
            interior = np.maximum(interior, i_max)
            edge = np.maximum(edge, e_max)
    level = np.full(n, -1, np.int64)
    for p_idx in reversed(range(len(plans))):
        _, i_bound, e_bound = plans[p_idx]
        level = np.where((interior <= i_bound) & (edge <= e_bound),
                         p_idx, level)
    return level


def dense_window_batch(bases: np.ndarray, lengths: np.ndarray,
                       crop_nt: int, masking_enabled: bool = True) -> bool:
    """Whole-batch dense predicate (see :func:`dense_window_rows`)."""
    if np.asarray(lengths).size == 0:
        return False
    return bool(dense_window_rows(bases, lengths, crop_nt,
                                  masking_enabled).all())


def pack_bases(bases: np.ndarray) -> np.ndarray:
    """Pack base IDs two-per-byte (4-bit nibbles) for host->device
    transfer. Exact for the 9-symbol alphabet. Pads odd lengths with N."""
    n, L = bases.shape
    if L % 2:
        bases = np.pad(bases, ((0, 0), (0, 1)), constant_values=4)
        L += 1
    b = bases.astype(np.uint8)
    return (b[:, 0::2] | (b[:, 1::2] << 4)).astype(np.uint8)


def unpack_bases(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Device-side inverse of :func:`pack_bases` -> (N, length) uint8."""
    lo = packed & 0x0F
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
    return out[:, :length]


def encode_frames(
    bases: torch.Tensor,
    lengths: torch.Tensor,
    crop_size: int,
    masking: bool = False,
    alphabet: str = "CODON",
) -> torch.Tensor:
    """Encode base IDs to 6-frame codon tokens.

    Args:
        bases: (B, >=crop_size) uint8 base IDs.
        lengths: (B,) int — valid bases per window.
        crop_size: nucleotide crop C.
        masking: when True, soft-masked (lowercase) bases are ambiguous.

    Returns:
        (B, 6, K) int32 tokens; 0 = pad/ambiguous (masked), 1..depth =
        codon class + 1. Frame order f1,f2,f3,r1,r2,r3.
    """
    C = int(crop_size)
    k = frame_positions(C)

    raw = bases[:, :C].to(torch.int32)
    # lowercase ids 5-8 fold to 0-3 (masking off) or to N=4 (masking on)
    if masking:
        b = torch.where(raw >= 4, torch.full_like(raw, 4), raw)
    else:
        b = torch.where(raw >= 5, raw - 5, raw)
    m = torch.clamp(lengths.to(torch.int32), max=C)  # valid bases in the crop

    # reverse complement of the valid prefix, re-padded with N on the
    # right: row i of JAX's slice [C - m, 2C - m) of [flip(comp), N * C].
    # Windows narrower than the crop (W < C) shift that slice by C - W,
    # as in JAX
    comp_b = torch.where(b < 4, b ^ 1, torch.full_like(b, 4))
    pos = torch.arange(C, dtype=torch.int32, device=b.device)[None, :]
    idx = m[:, None] - 1 - pos - (C - b.shape[1])
    rb = torch.where(
        idx >= 0,
        torch.gather(comp_b, 1, idx.clamp_min(0).to(torch.int64)),
        comp_b.new_full((b.shape[0], C), 4),
    )

    fwd = _frames_from_codons(_trigram_codons(b, alphabet), k)
    rev = _frames_from_codons(_trigram_codons(rb, alphabet), k)
    frames = torch.cat([fwd, rev], dim=1)  # (B, 6, K)

    # per-window valid frame positions: P = ceil((m - 5 + offset) / 3)
    offset = crop_contract.OFFSET_LUT[C % 3]
    p_valid = torch.clamp_min(-torch.div(-(m - 5 + offset), 3,
                                         rounding_mode="floor"), 0)
    valid = (torch.arange(k, dtype=torch.int32, device=b.device)[None, None, :]
             < p_valid[:, None, None])
    return (frames + 1) * valid.to(torch.int32)


def encode_nucleotide(
    bases: torch.Tensor,
    lengths: torch.Tensor,
    crop_size: int,
    masking: bool = False,
) -> torch.Tensor:
    """Encode base IDs to the 2-strand one-hot nucleotide input.

    Args:
        bases: (B, >=crop_size) uint8 base IDs.
        lengths: (B,) int — valid bases per window.
        crop_size: nucleotide crop C.
        masking: when True, soft-masked (lowercase) bases are ambiguous.

    Returns:
        (B, 2, C, 4) float32: the forward strand and the reverse
        complement of the valid prefix, one-hot in A, G, C, T order;
        ambiguous bases and padding are all-zero rows.
    """
    C = int(crop_size)
    raw = bases[:, :C].to(torch.int32)
    if masking:
        b = torch.where(raw >= 4, torch.full_like(raw, 4), raw)
    else:
        b = torch.where(raw >= 5, raw - 5, raw)
    m = torch.clamp(lengths.to(torch.int32), max=C)
    pos = torch.arange(C, dtype=torch.int32, device=b.device)[None, :]
    b = torch.where(pos < m[:, None], b, torch.full_like(b, 4))
    # reverse complement of the valid prefix, re-padded with N
    comp_b = torch.where(b < 4, b ^ 1, torch.full_like(b, 4))
    idx = m[:, None] - 1 - pos
    rb = torch.where(
        idx >= 0, torch.gather(comp_b, 1, idx.clamp_min(0).to(torch.int64)),
        torch.full_like(comp_b, 4))
    nuc = torch.tensor(_NUC_ID, dtype=torch.int64, device=b.device)
    ids = torch.stack([nuc[b.long()], nuc[rb.long()]], dim=1)  # (B, 2, C)
    return (ids[..., None] == torch.arange(4, device=b.device)).float()
