"""Copy of `jaeger_tpu/dataops/dedupe.py`.

MinHash ANI-style fragment dereplication.

Role parity: the reference shells out to the external ``mmseqs2`` binary
to build a non-redundant fragment DB by clustering at an identity
threshold (``commands/utils.py:170``). This module provides the in-repo
equivalent SURVEY §2.5 proposed: canonical-k-mer MinHash sketches with
LSH banding — fragments whose estimated Jaccard similarity (a proxy for
ANI at k=15) exceeds the threshold deduplicate greedily in one pass,
O(n) with no external tools.
"""

from __future__ import annotations

import numpy as np

_CODE = np.full(256, 4, dtype=np.int64)
for i, ch in enumerate("ACGT"):
    _CODE[ord(ch)] = i
    _CODE[ord(ch.lower())] = i

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — cheap vectorized 64-bit hash mix."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
    x = ((x ^ (x >> np.uint64(30)))
         * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
    x = ((x ^ (x >> np.uint64(27)))
         * np.uint64(0x94D049BB133111EB)) & _MASK64
    return x ^ (x >> np.uint64(31))


def minhash_sketch_aa(seq: str, k: int = 7, size: int = 32) -> np.ndarray:
    """AA-level sketch for AAI-style dereplication (reference mmseqs2
    ``--method AAI``): the sequence is translated in all six frames with
    the standard code, the per-frame AA k-mers are hashed, and the
    sketch keeps the smallest ``size`` hashes across frames — so
    nucleotide-level synonymous changes that preserve the protein still
    collide."""
    from jaeger_tpu_torch.seqops.maps import GENETIC_CODE

    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    frames = []
    for s in (seq.upper(), seq.translate(comp)[::-1].upper()):
        for off in range(3):
            frames.append("".join(
                GENETIC_CODE.get(s[i : i + 3], "X")
                for i in range(off, len(s) - 2, 3)))
    hashes: list[np.ndarray] = []
    for aa in frames:
        if len(aa) < k:
            continue
        b = np.frombuffer(aa.encode("ascii"), dtype=np.uint8)
        n = b.shape[0] - k + 1
        h = np.zeros(n, dtype=np.uint64)
        for i in range(k):
            h = (h * np.uint64(131)
                 + b[i : n + i].astype(np.uint64)) & _MASK64
        hashes.append(_splitmix64(h))
    if not hashes:
        return np.empty(0, dtype=np.uint64)
    merged = np.unique(np.concatenate(hashes))
    return merged[: min(size, merged.size)]


def minhash_sketch(seq: str, k: int = 15, size: int = 32) -> np.ndarray:
    """Sorted ``size`` smallest hashes of the canonical k-mers of *seq*.

    Canonical = min(kmer, revcomp(kmer)) so both strands sketch
    identically; k-mers containing non-ACGT bases are dropped. Returns
    fewer than ``size`` values for very short/degenerate sequences.
    """
    codes = _CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    fwd = np.zeros(n, dtype=np.int64)
    rc = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        c = codes[i : n + i]
        valid &= c < 4
        fwd = (fwd << 2) | np.where(c < 4, c, 0)
        rc |= np.where(c < 4, 3 - c, 0) << (2 * i)
    canon = np.minimum(fwd, rc)[valid].astype(np.uint64)
    if canon.size == 0:
        return np.empty(0, dtype=np.uint64)
    hashes = np.unique(_splitmix64(canon))
    return hashes[: min(size, hashes.size)]


class MinHashDeduper:
    """Greedy one-pass dereplicator with LSH banding.

    A fragment is a duplicate when its estimated Jaccard similarity to
    ANY previously kept fragment reaches ``threshold``. Candidate pairs
    come from shared LSH bands (``bands`` slices of the sketch), so the
    pass stays O(n) — only band-colliding sketches are compared.
    """

    def __init__(self, threshold: float = 0.8, k: int = 15,
                 size: int = 32, bands: int = 8, mode: str = "nt"):
        if not 0 < threshold <= 1:
            raise ValueError(f"threshold must be in (0, 1]: {threshold}")
        if mode not in ("nt", "aa"):
            raise ValueError(f"mode must be 'nt' (ANI) or 'aa' (AAI): {mode}")
        self.threshold = threshold
        self.k = 7 if mode == "aa" and k == 15 else k
        self.size = size
        self.bands = bands
        self.mode = mode
        self._sketches: list[np.ndarray] = []
        self._band_index: dict[tuple, list[int]] = {}

    def _band_keys(self, sketch: np.ndarray):
        r = max(1, self.size // self.bands)
        for b in range(0, min(sketch.size, self.size), r):
            chunk = sketch[b : b + r]
            if chunk.size:
                yield (b, chunk.tobytes())

    def is_duplicate(self, seq: str) -> bool:
        """Check *seq* against kept fragments; keep it when novel."""
        sketch_fn = minhash_sketch_aa if self.mode == "aa" else minhash_sketch
        sk = sketch_fn(seq, self.k, self.size)
        if sk.size == 0:
            return False  # degenerate: keep, exact layers catch repeats
        cand: set[int] = set()
        keys = list(self._band_keys(sk))
        for key in keys:
            cand.update(self._band_index.get(key, ()))
        for idx in cand:
            other = self._sketches[idx]
            union = min(self.size, max(sk.size, other.size))
            inter = np.intersect1d(sk, other, assume_unique=True).size
            if union and inter / union >= self.threshold:
                return True
        idx = len(self._sketches)
        self._sketches.append(sk)
        for key in keys:
            self._band_index.setdefault(key, []).append(idx)
        return False

    def __len__(self) -> int:
        return len(self._sketches)
