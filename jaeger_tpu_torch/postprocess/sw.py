"""Copy of `jaeger_tpu/postprocess/sw.py`.

Smith-Waterman local alignment with affine gaps and traceback.

Replaces the reference's parasail dependency (``sw_trace_scan_16`` calls at
``utils/termini.py:108-131`` and ``postprocess/prophages.py:734-814``).
Scoring conventions follow parasail: a substitution matrix (the reference
uses match=2 / mismatch=-100 over ACGT), ``open`` = cost of a length-1 gap,
``extend`` = cost of each additional gap position.

Pure numpy (row-vectorized DP); inputs in this codebase are <= 4 kb contig
flanks, so the O(n*m) DP with stored int16 score matrices is well within
budget. The C++ native path takes over for bulk workloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from jaeger_tpu_torch import native

_NEG = -(10**6)


@dataclass
class SWResult:
    score: int
    end_query: int   # 0-based index of last aligned query position
    end_ref: int     # 0-based index of last aligned ref position
    query_aligned: str
    ref_aligned: str
    comp: str        # '|' match, '.' mismatch, ' ' gap
    saturated: bool = False

    @property
    def length(self) -> int:
        return len(self.query_aligned)


def _score_lut(match: int, mismatch: int) -> np.ndarray:
    lut = np.full((256, 256), mismatch, dtype=np.int32)
    for ch in b"ACGTacgt":
        u = ord(chr(ch).upper())
        lo = ord(chr(ch).lower())
        for other in (u, lo):
            lut[ch, other] = match
    # N never matches anything (not in the parasail ACGT matrix -> mismatch)
    return lut


def smith_waterman(
    query: str,
    ref: str,
    open_: int = 100,
    extend: int = 5,
    match: int = 2,
    mismatch: int = -100,
) -> SWResult:
    """Local alignment of ``query`` vs ``ref`` with traceback.

    Dispatches to the C++ DP when built (identical output, pinned by
    tests/test_torch_native.py); ``JAEGER_TPU_TORCH_NATIVE=0`` forces the
    numpy path.
    """
    if native.available():
        return native.smith_waterman_native(query, ref, open_, extend, match,
                                            mismatch)
    q = np.frombuffer(query.upper().encode("ascii"), dtype=np.uint8)
    r = np.frombuffer(ref.upper().encode("ascii"), dtype=np.uint8)
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return SWResult(0, -1, -1, "", "", "")

    lut = _score_lut(match, mismatch)
    sub = lut[q[:, None], r[None, :]]  # (n, m)

    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    E = np.full((n + 1, m + 1), _NEG, dtype=np.int32)  # gap in query (left)
    F = np.full((n + 1, m + 1), _NEG, dtype=np.int32)  # gap in ref (up)

    ramp = extend * np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        # F depends only on the previous row — fully vectorized
        F[i, 1:] = np.maximum(H[i - 1, 1:] - open_, F[i - 1, 1:] - extend)
        diag = H[i - 1, :-1] + sub[i - 1]
        h = np.zeros(m + 1, dtype=np.int64)
        h[1:] = np.maximum(np.maximum(diag, F[i, 1:]), 0)
        # E[i,j] = max_{k<j} H[i,k] - open - extend*(j-1-k) couples to H
        # within the row. Lazy evaluation: compute E from the current h via
        # a prefix running max, fold into h, repeat until fixed point
        # (monotone + bounded => exact; converges in 1-2 passes with the
        # large gap-open cost used here).
        e = np.full(m + 1, _NEG, dtype=np.int64)
        while True:
            cand = h - open_ + ramp  # candidate at its own index k
            acc = np.maximum.accumulate(cand[:-1])
            e_new = acc - ramp[1:] + extend  # = max_k cand[k] - ext*(j-1)
            e[1:] = np.maximum(e[1:], e_new)
            h_new = np.maximum(h[1:], e[1:])
            if np.array_equal(h_new, h[1:]):
                break
            h[1:] = h_new
        E[i] = e
        H[i] = h

    best_flat = np.argmax(H)
    bi, bj = divmod(int(best_flat), m + 1)
    score = int(H[bi, bj])
    if score == 0:
        return SWResult(0, -1, -1, "", "", "")

    # traceback
    qa, ra, comp = [], [], []
    i, j = bi, bj
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            h = H[i, j]
            if h == 0:
                break
            if h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                qa.append(chr(q[i - 1]))
                ra.append(chr(r[j - 1]))
                comp.append("|" if sub[i - 1, j - 1] == match else ".")
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            elif h == F[i, j]:
                state = "F"
            else:  # numerical tie fallback
                break
        elif state == "E":
            qa.append("-")
            ra.append(chr(r[j - 1]))
            comp.append(" ")
            if E[i, j] == H[i, j - 1] - open_:
                state = "H"
            j -= 1
        else:  # F
            qa.append(chr(q[i - 1]))
            ra.append("-")
            comp.append(" ")
            if F[i, j] == H[i - 1, j] - open_:
                state = "H"
            i -= 1

    return SWResult(
        score=score,
        end_query=bi - 1,
        end_ref=bj - 1,
        query_aligned="".join(reversed(qa)),
        ref_aligned="".join(reversed(ra)),
        comp="".join(reversed(comp)),
    )
