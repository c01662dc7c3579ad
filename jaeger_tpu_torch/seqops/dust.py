"""Copy of `jaeger_tpu/seqops/dust.py`.

Symmetric DUST (SDUST) low-complexity masking.

Replaces the reference's ``pydustmasker`` Rust dependency (used at
``seqops/io.py:106-108`` with ``window_size=64, score_threshold=20``).
Implements the SDUST algorithm of Morgulis, Gertz, Schäffer & Agarwala
(2006): a sliding window of W bases; every windowed interval is scored
``10 * sum_t C(c_t, 2) / (L - 1)`` over its triplet counts ``c_t`` (L =
number of triplets), and the union of *perfect* intervals (score above the
threshold and not dominated by a containing interval) is soft-masked
(lowercased).

This pure-Python version is the behavioural oracle; the C++ fast path in
:mod:`jaeger_tpu_torch.native` implements the same algorithm for bulk ingest.
"""

from __future__ import annotations

from collections import deque

from jaeger_tpu_torch import native

_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}


def _sdust_run(codes: list[int], W: int, T: int) -> list[tuple[int, int]]:
    """Run SDUST over one uninterrupted A/C/G/T run.

    ``codes`` are 2-bit base codes; returns masked base intervals
    ``[start, end]`` inclusive, in run-local coordinates.
    """
    n = len(codes)
    if n < 3:
        return []

    res: list[list[int]] = []  # merged masked intervals, base coords
    # perfect intervals, sorted by start descending: (start_triplet, finish_base, num, den)
    P: list[tuple[int, int, int, int]] = []
    w: deque[int] = deque()  # triplets in window (max W-2)
    cw = [0] * 64  # counts in window
    cv = [0] * 64  # counts in suffix v
    L = 0  # length of suffix v (in triplets)
    rw = 0  # sum C(cw,2) over window
    rv = 0  # sum C(cv,2) over suffix

    def emit(start_t: int, finish_b: int) -> None:
        # merge [start_t, finish_b] (base coords) into res
        if res and start_t <= res[-1][1] + 1:
            if finish_b > res[-1][1]:
                res[-1][1] = finish_b
        else:
            res.append([start_t, finish_b])

    num_triplets = n - 2
    for i in range(num_triplets):
        # window start in triplet coordinates
        start = i - (W - 2) + 1
        if start < 0:
            start = 0
        # flush perfect intervals that fell out of the window
        if P and P[-1][0] < start:
            while P and P[-1][0] < start:
                s_t, f_b, _, _ = P.pop()
                emit(s_t, f_b)

        t = (codes[i] << 4) | (codes[i + 1] << 2) | codes[i + 2]

        # --- shift window ---
        if len(w) >= W - 2:
            s = w.popleft()
            cw[s] -= 1
            rw -= cw[s]
            if L > len(w):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        w.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > 2 * T:
            # drop the prefix of v up to (and including) the first occurrence
            # of t, keeping the suffix's per-triplet score bounded
            while True:
                s = w[len(w) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

        # --- find perfect intervals ending at the current position ---
        # scan left from just before the suffix v, extending the interval
        c = cv.copy()
        r = rv
        w_len = len(w)
        w_start = i + 1 - w_len  # triplet coord of w[0]
        max_num, max_den = 0, 1  # best score among contained intervals
        new_entries: list[tuple[int, int, int, int]] = []
        for idx in range(w_len - L - 1, -1, -1):
            tt = w[idx]
            r += c[tt]
            c[tt] += 1
            new_len = w_len - idx - 1  # denominator (L' - 1)
            if r * 10 > T * new_len:
                new_start = idx + w_start
                # max score among perfect intervals starting inside this one
                j = 0
                while j < len(P) and P[j][0] >= new_start:
                    pn, pd = P[j][2], P[j][3]
                    if max_num * pd < pn * max_den:
                        max_num, max_den = pn, pd
                    j += 1
                for en, ed in [(e[2], e[3]) for e in new_entries]:
                    if max_num * ed < en * max_den:
                        max_num, max_den = en, ed
                if r * max_den >= max_num * new_len:
                    new_entries.append((new_start, i + 2, r, new_len))
        # insert new entries keeping P sorted by start descending
        for entry in sorted(new_entries, key=lambda e: -e[0]):
            j = 0
            while j < len(P) and P[j][0] >= entry[0]:
                j += 1
            P.insert(j, entry)

    # final flush
    while P:
        s_t, f_b, _, _ = P.pop()
        emit(s_t, f_b)
    return [(a, b) for a, b in res]


def dust_intervals(
    seq: str, window_size: int = 64, score_threshold: int = 20
) -> list[tuple[int, int]]:
    """Masked intervals ``[start, end)`` (half-open, sequence coords)."""
    out: list[tuple[int, int]] = []
    run_start = None
    codes: list[int] = []
    for pos, ch in enumerate(seq):
        code = _BASE_CODE.get(ch)
        if code is None:
            if run_start is not None:
                for a, b in _sdust_run(codes, window_size, score_threshold):
                    out.append((run_start + a, run_start + b + 1))
                run_start, codes = None, []
        else:
            if run_start is None:
                run_start = pos
            codes.append(code)
    if run_start is not None:
        for a, b in _sdust_run(codes, window_size, score_threshold):
            out.append((run_start + a, run_start + b + 1))
    return out


def dust_mask(seq: str, window_size: int = 64, score_threshold: int = 20) -> str:
    """Soft-mask (lowercase) low-complexity regions of ``seq``.

    Dispatches to the C++ implementation when built (identical output,
    pinned by tests/test_torch_native.py); set
    ``JAEGER_TPU_TORCH_NATIVE=0`` to force the Python path.
    """
    if native.available():
        return native.dust_mask_native(seq, window_size, score_threshold)
    intervals = dust_intervals(seq, window_size, score_threshold)
    if not intervals:
        return seq
    chars = list(seq)
    for a, b in intervals:
        chars[a:b] = [c.lower() for c in chars[a:b]]
    return "".join(chars)
