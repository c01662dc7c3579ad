"""Copy of `jaeger_tpu/seqops/tandem.py`.

TRF-style tandem-repeat detection and hard masking.

Replaces the reference's external ``trf`` binary pipeline (reference
``seqops/io.py:26-35`` parameters, ``:371-441`` split/run/merge plumbing;
wired — currently disabled — into predict at
``commands/predict.py:665-677``): the reference splits the input FASTA
into chunks, runs ``trf <chunk> 2 7 7 80 10 50 500 -h -m`` per chunk in a
process pool, and merges the N-masked chunk FASTAs.

This in-process rebuild keeps TRF's repeat model and scoring weights
(match=+2, mismatch=-7, minscore=50, maxperiod=500) but needs no binary,
no chunk files and no merge step:

1. **candidate periods** per record from exact k-mer recurrence distances
   (Benson 1999's detection stage, reduced to exact seeds): every
   distance ``d <= maxperiod`` at which a k-mer recurs often enough is a
   candidate period. Candidates only bound the scan — a false candidate
   costs one vectorized pass, never a false mask.
2. **self-alignment at lag d**: positions where ``seq[i] == seq[i+d]``
   score +match, else -mismatch. Maximal-sum segments (Kadane, fully
   vectorized via prefix sums + running minima) with score >= minscore
   mark the repeat; bases ``[seg_start, seg_end + d)`` are the repeat
   tract (the matched stretch plus the template period upstream).
3. intervals are merged across periods and records masked to ``N``
   (TRF's ``-m`` output).

Documented divergence vs TRF: no wraparound-DP consensus alignment and
no PM/PI/Delta probabilistic detection model, so indel-containing
repeats are approximated by nearby lags (an indel shifts the period by
one, caught at ``d±1``); interval-level agreement is what masking needs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

# TRF command-line parameters mirrored from the reference
# (``seqops/io.py:26-35``): match, mismatch, indel, PM, PI, minscore,
# maxperiod. PM/PI/indel belong to TRF's probabilistic detection model,
# which the exact-seed scan replaces; they are kept for interface parity.
TRF_MATCH = 2
TRF_MISMATCH = 7
TRF_DELTA = 7
TRF_PM = 80
TRF_PI = 10
TRF_MINSCORE = 50
TRF_MAXPERIOD = 500

_SEED_K = 7          # exact-seed k-mer size for period detection
_BASE_IDX = np.full(256, -1, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_IDX[_b] = _i
    _BASE_IDX[_b + 32] = _i  # lowercase


def _codes(sequence: str) -> np.ndarray:
    """Base codes 0..3, -1 for ambiguous, as int8."""
    return _BASE_IDX[np.frombuffer(sequence.encode("ascii"), np.uint8)]


def _candidate_periods(codes: np.ndarray, maxperiod: int) -> list[int]:
    """Distances at which exact k-mers recur — the candidate period set.

    The recurrence count threshold scales with the expected number of
    chance k-mer collisions so long records don't flood the scan stage;
    candidates are a performance bound only (stage 2 re-scores exactly).
    """
    n = codes.shape[0]
    k = _SEED_K
    if n < k + 1:
        return []
    valid = codes >= 0
    ids = np.zeros(n - k + 1, np.int64)
    ok = np.ones(n - k + 1, bool)
    for j in range(k):
        ids = ids * 4 + np.maximum(codes[j : n - k + 1 + j], 0)
        ok &= valid[j : n - k + 1 + j]
    pos = np.nonzero(ok)[0]
    ids = ids[ok]
    if ids.size < 2:
        return []
    order = np.argsort(ids, kind="stable")  # stable: positions ascending
    ids_s, pos_s = ids[order], pos[order]
    same = ids_s[1:] == ids_s[:-1]
    dist = (pos_s[1:] - pos_s[:-1])[same]
    dist = dist[dist <= maxperiod]
    if dist.size == 0:
        return []
    counts = np.bincount(dist, minlength=maxperiod + 1)
    # expected chance recurrences at one specific distance ~ n / 4^k
    thr = max(3, int(6.0 * n / 4**k))
    return np.nonzero(counts >= thr)[0].tolist()


def _segments_at_lag(
    codes: np.ndarray, d: int, match: int, mismatch: int, minscore: int
) -> list[tuple[int, int]]:
    """Base intervals ``[start, end)`` of >=minscore self-alignment
    segments at lag ``d``, via vectorized Kadane.

    ``eq[i]`` compares positions ``i`` and ``i+d``; a scoring segment
    ``[j, i]`` of ``eq`` means bases ``[j, i+d]`` repeat with period
    ``d``. The best segment ending at ``i`` is ``c[i] - min(0,
    min_{j<i} c[j])`` (prefix sums ``c``); its start is where that
    running minimum was attained, recovered vectorized so the Python
    loop only touches distinct repeat tracts.
    """
    a, b = codes[:-d], codes[d:]
    eq = (a == b) & (a >= 0)
    step = np.where(eq, float(match), -float(mismatch))
    c = np.cumsum(step)
    cm = np.concatenate([[0.0], c[:-1]])  # prefix sum before i
    runmin = np.minimum.accumulate(cm)
    s = c - runmin  # best segment sum ending at i
    trig = s >= minscore
    if not trig.any():
        return []
    # index where the running minimum was (last) attained = segment start
    attain = np.where(cm == runmin, np.arange(cm.shape[0]), -1)
    start_at = np.maximum.accumulate(attain)
    t_idx = np.nonzero(trig)[0]
    t_start = start_at[t_idx]
    out: list[tuple[int, int]] = []
    # group triggers sharing a segment start: one tract each. The tract
    # END is the maximum-score endpoint (argmax of c within the group),
    # not the last above-threshold index — the score stays >= minscore
    # for ~peak/mismatch bases past the true repeat end otherwise.
    cuts = np.nonzero(np.diff(t_start))[0]
    bounds = np.concatenate([[0], cuts + 1, [t_idx.shape[0]]])
    for u, v in zip(bounds[:-1], bounds[1:]):
        j = int(t_start[u])
        grp = t_idx[u:v]
        i = int(grp[np.argmax(c[grp])])
        out.append((j, i + d + 1))
    return out


def _merge_intervals(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def find_tandem_repeats(
    sequence: str,
    match: int = TRF_MATCH,
    mismatch: int = TRF_MISMATCH,
    minscore: int = TRF_MINSCORE,
    maxperiod: int = TRF_MAXPERIOD,
) -> list[tuple[int, int]]:
    """Merged 0-based half-open tandem-repeat intervals of ``sequence``."""
    codes = _codes(sequence)
    maxperiod = min(maxperiod, codes.shape[0] // 2)
    intervals: list[tuple[int, int]] = []
    for d in _candidate_periods(codes, maxperiod):
        intervals.extend(
            _segments_at_lag(codes, int(d), match, mismatch, minscore)
        )
    return _merge_intervals(intervals)


def mask_tandem_repeats(sequence: str, **kwargs) -> str:
    """``sequence`` with tandem-repeat tracts hard-masked to ``N``
    (TRF's ``-m`` masked-FASTA semantics)."""
    iv = find_tandem_repeats(sequence, **kwargs)
    if not iv:
        return sequence
    buf = np.frombuffer(sequence.encode("ascii"), np.uint8).copy()
    for s, e in iv:
        buf[s:e] = ord("N")
    return buf.tobytes().decode("ascii")


def mask_fasta(
    input_path: str,
    output_path: str,
    workers: int | None = None,
    width: int = 60,
    **kwargs,
) -> int:
    """Write an N-masked copy of a FASTA; returns masked-base count.

    One call replaces the reference's split -> ``run_trf_batch`` (process
    pool over chunk files) -> ``merge_masked_files`` pipeline
    (``seqops/io.py:371-441``): records are masked in parallel by a
    thread pool (the numpy scans release the GIL) and written in input
    order, so the output is deterministic and needs no merge step.
    """
    from jaeger_tpu_torch.seqops.fasta import read_fasta

    records = list(read_fasta(str(input_path)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        masked = list(
            pool.map(lambda r: mask_tandem_repeats(r[1], **kwargs), records)
        )
    n_masked = 0
    with open(output_path, "w") as fh:
        for (header, seq), mseq in zip(records, masked):
            n_masked += sum(
                1 for a, b in zip(seq, mseq) if b == "N" and a.upper() != "N"
            )
            fh.write(f">{header}\n")
            for i in range(0, len(mseq), width):
                fh.write(mseq[i : i + width] + "\n")
    return n_masked
