"""Windows and six-frame codon tokens, written from the published
description of Jaeger's input (upstream ``seqops/io.py`` and
``seqops/encode.py``).

A contig of ``n`` bases gives windows at ``range(0, n - fsize + 1,
stride)``; a contig shorter than ``fsize`` but at least ``min_len`` long
gives one window of the whole contig. Bases are upper-cased; A, T, G, C
keep their identity and every other letter is ambiguous. DUST's soft mask
(lower case) is folded back onto the base when the model's ``masking`` is
off, which both configurations of this benchmark state, so it changes no
token here.

A window of ``m`` valid bases in a crop of ``C`` gives six frames (three
forward, three on the reverse complement of the valid prefix) of ``K =
ceil((C - 5 + off) / 3)`` codon tokens, ``off = (-2, -1, 0)[C % 3]``, of
which the first ``ceil((m - 5 + off) / 3)`` are valid. A token is the
codon's index in the classical table (second base slowest, then the
first, then the third, each in T, C, A, G order) plus one; a codon with
an ambiguous base, and every position past the valid ones, is 0.
"""

from __future__ import annotations

import numpy as np
import torch

#: ASCII -> base id: A 0, T 1, G 2, C 3, anything else 4
ASCII_TO_ID = np.full(256, 4, np.uint8)
for _ch, _id in zip(b"ATGC", range(4)):
    ASCII_TO_ID[_ch] = _id
    ASCII_TO_ID[_ch + 32] = _id

_TCAG = "TCAG"
CODONS = [b1 + b2 + b3 for b2 in _TCAG for b1 in _TCAG for b3 in _TCAG]
#: vocabulary of the token embedding: 64 codons and the masked token 0
VOCAB = len(CODONS) + 1


def _token_table() -> torch.Tensor:
    """(125,) token of the trigram ``b0 * 25 + b1 * 5 + b2`` of base ids."""
    index = {c: i for i, c in enumerate(CODONS)}
    table = torch.zeros(125, dtype=torch.long)
    for b0 in range(4):
        for b1 in range(4):
            for b2 in range(4):
                tri = "ATGC"[b0] + "ATGC"[b1] + "ATGC"[b2]
                table[b0 * 25 + b1 * 5 + b2] = index[tri] + 1
    return table


TOKENS = _token_table()
COMPLEMENT = torch.tensor([1, 0, 3, 2, 4])


def window_starts(n: int, fsize: int, stride: int, min_len: int) -> list[int]:
    """Start of every window of a contig of ``n`` bases."""
    if n >= fsize:
        return list(range(0, n - fsize + 1, stride))
    return [0] if n >= min_len else []


def contig_windows(seq: np.ndarray, fsize: int, stride: int,
                   min_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(windows (W, fsize) base ids padded with 4, lengths (W,)) of one
    contig given as ASCII bytes."""
    ids = ASCII_TO_ID[seq]
    starts = window_starts(len(ids), fsize, stride, min_len)
    out = np.full((len(starts), fsize), 4, np.uint8)
    lengths = np.zeros(len(starts), np.int64)
    for i, s in enumerate(starts):
        piece = ids[s:s + fsize]
        out[i, :len(piece)] = piece
        lengths[i] = len(piece)
    return out, lengths


def frame_count(valid: torch.Tensor | int, crop: int):
    """Valid frame positions of a window with ``valid`` bases in a crop of
    ``crop``: ``ceil((valid - 5 + off) / 3)``, at least 0."""
    off = (-2, -1, 0)[crop % 3]
    usable = valid - 5 + off
    if isinstance(usable, torch.Tensor):
        return torch.clamp_min(-torch.div(-usable, 3, rounding_mode="floor"), 0)
    return max(0, -(-usable // 3))


def six_frames(bases: torch.Tensor, lengths: torch.Tensor,
               crop: int) -> torch.Tensor:
    """(B, 6, K) tokens of base-id windows ``bases`` (B, W)."""
    n = bases.shape[0]
    dev = bases.device
    b = torch.full((n, crop), 4, dtype=torch.long, device=dev)
    w = min(crop, bases.shape[1])
    b[:, :w] = bases[:, :w].long()
    m = torch.clamp(lengths.long(), max=crop)
    pos = torch.arange(crop, device=dev)
    src = m[:, None] - 1 - pos[None, :]
    rev = torch.where(src >= 0,
                      COMPLEMENT.to(dev)[torch.gather(b, 1, src.clamp_min(0))],
                      torch.full_like(b, 4))
    k = frame_count(crop, crop)
    table = TOKENS.to(dev)
    frames = []
    for strand in (b, rev):
        tri = strand[:, :-2] * 25 + strand[:, 1:-1] * 5 + strand[:, 2:]
        ambiguous = (strand[:, :-2] > 3) | (strand[:, 1:-1] > 3) | (strand[:, 2:] > 3)
        tok = torch.where(ambiguous, torch.zeros_like(tri),
                          table[tri.clamp(max=124)])
        for f in range(3):
            col = tok[:, f::3][:, :k]
            if col.shape[1] < k:
                col = torch.nn.functional.pad(col, (0, k - col.shape[1]))
            frames.append(col)
    tokens = torch.stack(frames, dim=1)
    valid = torch.arange(k, device=dev)[None, None, :] < frame_count(m, crop)[:, None, None]
    return tokens * valid
