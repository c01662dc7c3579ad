"""Copy of `jaeger_tpu/seqops/windows.py`.

Contig windowing: FASTA -> fixed-length window batches of base IDs.

Parity target: the reference's ``fragment_generator``
(``seqops/io.py:74-147``), which yields per-window CSV strings
``seq,header,index,contig_end,i,seqlen,g,c,a,t,gc_skew``. The TPU-native
redesign emits the same information as **structured numpy arrays** — base
identifiers (1 byte/base) plus metadata columns — so the host->device
boundary moves bytes, not strings, and the codon translation runs on-device
(:mod:`jaeger_tpu_torch.ops.encode`).

Base-ID alphabet (uint8):
    0=A 1=T 2=G 3=C 4=N/other/pad 5=a 6=t 7=g 8=c
Lowercase IDs carry the DUST soft-mask; encoders either fold them onto the
uppercase IDs (``masking=False``, reference ``encode.py:139-141``) or treat
them as ambiguous (``masking=True``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

from jaeger_tpu_torch import native
from jaeger_tpu_torch.seqops.dust import dust_mask
from jaeger_tpu_torch.seqops.fasta import read_fasta

# ASCII -> base-ID lookup (everything unknown -> 4).
BASE_N = 4
_ASCII_LUT = np.full(256, BASE_N, dtype=np.uint8)
for _ch, _id in [("A", 0), ("T", 1), ("G", 2), ("C", 3),
                 ("a", 5), ("t", 6), ("g", 7), ("c", 8)]:
    _ASCII_LUT[ord(_ch)] = _id

#: Fold lowercase (soft-masked) IDs onto uppercase.
UPPER_LUT = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3], dtype=np.uint8)
#: Treat lowercase (soft-masked) IDs as ambiguous.
MASKED_LUT = np.array([0, 1, 2, 3, 4, 4, 4, 4, 4], dtype=np.uint8)


def encode_ascii(seq: str) -> np.ndarray:
    """Encode an ASCII DNA string to base IDs (vectorized)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ASCII_LUT[raw]


def window_indices(
    seqlen: int,
    fragsize: int,
    stride: int | None,
    dynamic_stride: bool = False,
    dynamic_stride_threshold: float = 10.0,
) -> list[int]:
    """Window start positions for one contig.

    Mirrors reference ``seqops/io.py:38-71``: fixed stride normally; when
    *dynamic_stride* is on and the contig is shorter than
    ``threshold * fragsize``, windows are spread evenly so the last one
    reaches the contig end.
    """
    if not dynamic_stride or seqlen >= dynamic_stride_threshold * fragsize:
        step = fragsize if stride is None else stride
        return list(range(0, seqlen - (fragsize - 1), step))
    n_windows = max(1, math.ceil(seqlen / fragsize))
    if n_windows == 1:
        return [0]
    raw_stride = (seqlen - fragsize) / (n_windows - 1)
    indices = [int(round(i * raw_stride)) for i in range(n_windows)]
    indices[-1] = seqlen - fragsize
    seen: set[int] = set()
    unique: list[int] = []
    for idx in indices:
        if idx not in seen:
            seen.add(idx)
            unique.append(idx)
    return unique


@dataclass
class WindowBatch:
    """A batch of fixed-capacity windows plus reference-parity metadata."""

    bases: np.ndarray          # (n, capacity) uint8 base IDs, padded with N
    length: np.ndarray         # (n,) int32 — valid bases per window
    contig: np.ndarray         # (n,) int32 — index into `headers`
    start: np.ndarray          # (n,) int32 — window start in the contig
    contig_end: np.ndarray     # (n,) int8 — 1 on the contig's last window
    ordinal: np.ndarray        # (n,) int32 — window number within the contig
    seqlen: np.ndarray         # (n,) int32 — full contig length
    g: np.ndarray              # (n,) int32
    c: np.ndarray              # (n,) int32
    a: np.ndarray              # (n,) int32
    t: np.ndarray              # (n,) int32
    gc_skew: np.ndarray        # (n,) float32, rounded to 3 decimals
    headers: list[str] = field(default_factory=list)

    def __len__(self) -> int:
        return int(self.bases.shape[0])


def _composition(ids: np.ndarray) -> tuple[int, int, int, int]:
    """(g, c, a, t) over UPPERCASE base IDs only — soft-masked
    (lowercase, ids 5-8) bases are excluded, matching the reference's
    case-sensitive counts (io.py:124-133)."""
    counts = np.bincount(ids, minlength=9)
    # base IDs: 0=A 1=T 2=G 3=C
    return int(counts[2]), int(counts[3]), int(counts[0]), int(counts[1])


def _gc_skew(g: int, c: int) -> float:
    # reference ``safe_divide`` rounds to 2 decimals (utils/misc.py:117-123)
    denom = g + c
    return round((g - c) / denom, 2) if denom else 0.0


def _fasta_source(path: str):
    """Native streaming reader when built, Python fallback otherwise."""
    if native.available():
        return native.read_fasta_native(str(path))
    return read_fasta(path)


def iter_contigs(
    path: str,
    dustmask: bool = True,
    replace_comma: bool = True,
) -> Iterator[tuple[str, np.ndarray, int]]:
    """Yield ``(header, base_ids, seqlen)`` per contig.

    Uppercases, optionally DUST-soft-masks (reference ``io.py:104-109``),
    and rewrites commas in headers to ``___`` like the reference.
    """
    for header, seq in _fasta_source(path):
        seqlen = len(seq)
        sequence = seq.strip().upper()
        if dustmask:
            sequence = dust_mask(sequence, window_size=64, score_threshold=20)
        if replace_comma:
            header = header.strip().replace(",", "___")
        yield header, encode_ascii(sequence), seqlen


def _contig_ids(sequence: str, dustmask: bool) -> np.ndarray:
    """Uppercase + optional DUST soft-mask + base-ID encode.

    Native fast path does all three in ONE C call without intermediate
    Python strings; the fallback reproduces it exactly (pinned by
    tests/test_torch_native.py).
    """
    if native.available():
        return native.contig_ids_native(sequence, dustmask, window=64,
                                        threshold=20)
    sequence = sequence.upper()
    if dustmask:
        sequence = dust_mask(sequence, window_size=64, score_threshold=20)
    return encode_ascii(sequence)


def _window_counts(ids: np.ndarray, starts: np.ndarray,
                   width: int) -> np.ndarray:
    """(n_windows, 4) per-window A/T/G/C counts over UPPERCASE base IDs
    only — soft-masked (lowercase, ids 5-8) bases are excluded, matching
    the reference's case-sensitive counts (io.py:124-133; pinned live)."""
    if native.available():
        return native.window_counts_native(ids, starts, width)
    ends = starts + width
    out = np.empty((starts.shape[0], 4), dtype=np.int64)
    for col in range(4):  # base IDs 0=A 1=T 2=G 3=C
        pos = np.flatnonzero(ids == col)
        out[:, col] = (np.searchsorted(pos, ends)
                       - np.searchsorted(pos, starts))
    return out


def _contig_rows(header, seq, fragsize, stride, dynamic_stride,
                 dynamic_stride_threshold, min_len, dustmask,
                 replace_comma=True):
    """Per-contig heavy work: uppercase + DUST + encode + window slicing
    + composition. Returns ``(header, bases2d | None, meta2d | None)``
    where ``bases2d`` is ``(W, w<=fragsize) uint8`` and ``meta2d`` is
    ``(W, 11) float64`` with columns ``[length, hidx(left 0), start,
    contig_end, ordinal, seqlen, g, c, a, t, gc_skew]`` (the batcher
    fills ``hidx``).

    The whole windowed path is ONE native call (``jt_contig_rows``) that
    releases the GIL for its full duration, so ``workers > 1`` thread
    pools scale with cores. The pure-Python fallback reproduces it
    exactly (pinned by tests/test_torch_native.py).
    """
    seqlen = len(seq)
    sequence = seq.strip()
    if replace_comma:
        header = header.strip().replace(",", "___")

    if seqlen >= fragsize and len(sequence) >= fragsize:
        starts = np.asarray(window_indices(
            seqlen, fragsize, stride, dynamic_stride,
            dynamic_stride_threshold,
        ), dtype=np.int64)
        if len(sequence) == seqlen and native.available():
            wins, meta = native.contig_rows_native(
                sequence, starts, fragsize, seqlen, dustmask)
            return header, wins, meta
        ids = _contig_ids(sequence, dustmask)
        counts = _window_counts(ids, starts, fragsize)
        a, t = counts[:, 0], counts[:, 1]
        g, c = counts[:, 2], counts[:, 3]
        # reference ``safe_divide`` rounds to 2 decimals with Python's
        # round(), which rounds the decimal expansion exactly — np.round
        # scales by 100 first and disagrees on half-way-straddling values
        # (caught by the live fuzz parity test), so skew stays scalar
        n_win = g.shape[0]
        skew = np.fromiter(
            (_gc_skew(gv, cv) for gv, cv in zip(g.tolist(), c.tolist())),
            dtype=np.float64, count=n_win)
        wins = ids[starts[:, None] + np.arange(fragsize)]
        meta = np.empty((n_win, 11), dtype=np.float64)
        meta[:, 0] = fragsize
        meta[:, 1] = 0.0
        meta[:, 2] = starts
        meta[:, 3] = 0.0
        meta[-1, 3] = 1.0
        meta[:, 4] = np.arange(n_win)
        meta[:, 5] = seqlen
        meta[:, 6] = g
        meta[:, 7] = c
        meta[:, 8] = a
        meta[:, 9] = t
        meta[:, 10] = skew
        return header, wins, meta
    ids = _contig_ids(sequence, dustmask)
    if seqlen >= min_len:
        g, c, a, t = _composition(ids)
        meta = np.array(
            [[ids.shape[0], 0, 0, 1, 0, seqlen, g, c, a, t,
              _gc_skew(g, c)]],
            dtype=np.float64,
        )
        return header, ids[None, :], meta
    return header, None, None


def window_batches(
    path: str,
    fragsize: int,
    stride: int | None = None,
    batch_capacity: int = 4096,
    dustmask: bool = True,
    dynamic_stride: bool = False,
    dynamic_stride_threshold: float = 10.0,
    min_len: int | None = None,
    max_len: int | None = None,
    contig_filter=None,
    workers: int = 0,
) -> Iterator[WindowBatch]:
    """Stream windows from a FASTA file in batches.

    Contigs >= ``fragsize`` produce sliding windows (reference
    ``io.py:112-133``); contigs in ``[min_len, fragsize)`` produce one
    whole-contig window (``io.py:134-145``) whose ``length < fragsize`` —
    the downstream encoder masks the tail. ``contig_filter(header)``
    drops non-matching contigs before windowing (multi-host contig
    sharding, parallel/multihost.py).

    ``workers > 1`` pipelines the per-contig work (DUST + encode +
    slicing) over a thread pool, in submission order so window/batch
    contents are IDENTICAL to the serial path (pinned by tests).
    Host-pipeline parallelism parity: the reference's tf.data AUTOTUNE
    maps (``commands/predict.py:219-245``).
    """
    if min_len is None:
        min_len = fragsize

    if contig_filter is None and native.available():
        # all-native pipeline: reader thread + worker pool + ordered
        # batcher in C++, one GIL-released call per batch. Byte-identical
        # output, pinned by tests/test_torch_native.py. contig_filter is
        # a Python callable, so multi-host sharding keeps the Python path.
        headers_acc: list[str] = []
        for bases2, meta2, new_headers in native.window_pipeline_native(
            path, fragsize, stride, dynamic_stride,
            dynamic_stride_threshold, min_len, max_len, dustmask,
            batch_capacity, max(1, workers),
        ):
            headers_acc.extend(new_headers)
            if bases2.shape[0] == 0:
                continue
            yield WindowBatch(
                bases=bases2,
                length=meta2[:, 0].astype(np.int32),
                contig=meta2[:, 1].astype(np.int32),
                start=meta2[:, 2].astype(np.int32),
                contig_end=meta2[:, 3].astype(np.int8),
                ordinal=meta2[:, 4].astype(np.int32),
                seqlen=meta2[:, 5].astype(np.int32),
                g=meta2[:, 6].astype(np.int32),
                c=meta2[:, 7].astype(np.int32),
                a=meta2[:, 8].astype(np.int32),
                t=meta2[:, 9].astype(np.int32),
                gc_skew=meta2[:, 10].astype(np.float32),
                headers=list(headers_acc),
            )
        return

    cap = fragsize
    # per-contig blocks of (bases2d, meta2d-with-hidx); batch boundaries
    # split blocks so batches stay exactly `batch_capacity` rows, like the
    # old per-window accumulation did
    blocks: list[tuple[np.ndarray, np.ndarray]] = []
    n_buf = 0
    headers: list[str] = []

    def flush() -> WindowBatch:
        bases = np.full((n_buf, cap), BASE_N, dtype=np.uint8)
        row = 0
        for b2, _ in blocks:
            bases[row: row + b2.shape[0], : b2.shape[1]] = b2
            row += b2.shape[0]
        cols = (np.concatenate([m for _, m in blocks], axis=0)
                if blocks else np.zeros((0, 11), dtype=np.float64))
        batch = WindowBatch(
            bases=bases,
            length=cols[:, 0].astype(np.int32),
            contig=cols[:, 1].astype(np.int32),
            start=cols[:, 2].astype(np.int32),
            contig_end=cols[:, 3].astype(np.int8),
            ordinal=cols[:, 4].astype(np.int32),
            seqlen=cols[:, 5].astype(np.int32),
            g=cols[:, 6].astype(np.int32),
            c=cols[:, 7].astype(np.int32),
            a=cols[:, 8].astype(np.int32),
            t=cols[:, 9].astype(np.int32),
            gc_skew=cols[:, 10].astype(np.float32),
            headers=list(headers),
        )
        return batch

    def raw_records():
        for header, seq in _fasta_source(path):
            if max_len is not None and len(seq) > max_len:
                continue
            if contig_filter is not None and not contig_filter(
                header.strip().replace(",", "___")
            ):
                continue
            yield header, seq

    def processed():
        if workers and workers > 1:
            # ordered bounded pipeline: contigs submit in file order and
            # results consume FIFO, so output is byte-identical to serial
            import collections
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as ex:
                pending = collections.deque()
                src = raw_records()
                for header, seq in src:
                    pending.append(ex.submit(
                        _contig_rows, header, seq, fragsize, stride,
                        dynamic_stride, dynamic_stride_threshold,
                        min_len, dustmask,
                    ))
                    if len(pending) >= workers * 2:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
        else:
            for header, seq in raw_records():
                yield _contig_rows(
                    header, seq, fragsize, stride, dynamic_stride,
                    dynamic_stride_threshold, min_len, dustmask,
                )

    for header, wins, meta11 in processed():
        # sub-min_len contigs still consume a header slot (parity with
        # the reference's global contig indexing)
        headers.append(header)
        if wins is None:
            continue
        n_win = meta11.shape[0]
        meta11[:, 1] = len(headers) - 1  # hidx, left 0 by _contig_rows
        off = 0
        while off < n_win:
            take = min(n_win - off, batch_capacity - n_buf)
            blocks.append((wins[off: off + take],
                           meta11[off: off + take]))
            n_buf += take
            off += take
            if n_buf >= batch_capacity:
                yield flush()
                blocks, n_buf = [], 0
                # keep headers: contig indices refer into the shared list

    if n_buf:
        yield flush()


def windows_from_sequences(
    sequences: Sequence[str],
    headers: Sequence[str] | None = None,
    fragsize: int | None = None,
) -> WindowBatch:
    """Build a WindowBatch directly from in-memory sequences (tests, train)."""
    if headers is None:
        headers = [f"seq_{i}" for i in range(len(sequences))]
    cap = fragsize or max(len(s) for s in sequences)
    n = len(sequences)
    bases = np.full((n, cap), BASE_N, dtype=np.uint8)
    length = np.zeros(n, dtype=np.int32)
    g = np.zeros(n, dtype=np.int32)
    c = np.zeros(n, dtype=np.int32)
    a = np.zeros(n, dtype=np.int32)
    t = np.zeros(n, dtype=np.int32)
    skew = np.zeros(n, dtype=np.float32)
    for i, s in enumerate(sequences):
        ids = encode_ascii(s[:cap])
        bases[i, : ids.shape[0]] = ids
        length[i] = ids.shape[0]
        gg, cc, aa, tt = _composition(ids)
        g[i], c[i], a[i], t[i] = gg, cc, aa, tt
        skew[i] = _gc_skew(gg, cc)
    seqlens = np.array([len(s) for s in sequences], dtype=np.int32)
    return WindowBatch(
        bases=bases,
        length=length,
        contig=np.arange(n, dtype=np.int32),
        start=np.zeros(n, dtype=np.int32),
        contig_end=np.ones(n, dtype=np.int8),
        ordinal=np.zeros(n, dtype=np.int32),
        seqlen=seqlens,
        g=g, c=c, a=a, t=t,
        gc_skew=skew,
        headers=list(headers),
    )
