"""Copy of `jaeger_tpu/seqops/transform.py`.

Sequence transforms: reverse complement and shuffles.

Parity targets: reference ``seqops/transform.py`` — IUPAC-aware reverse
complement, mononucleotide shuffle, k-mer shuffle, and the
Altschul–Erickson dinucleotide-preserving shuffle (implemented here as the
classic Euler-path walk over the dinucleotide transition graph).
"""

from __future__ import annotations

import numpy as np

_IUPAC = {
    "A": "T", "T": "A", "C": "G", "G": "C", "-": "-", "N": "N",
    "W": "W", "S": "S", "Y": "R", "R": "Y", "M": "K", "K": "M",
    "B": "V", "V": "B", "H": "D", "D": "H",
    "a": "T", "t": "A", "g": "C", "c": "G",
}


def reverse_complement(dna_sequence: str) -> str:
    """IUPAC-aware reverse complement (unknown symbols -> N)."""
    return "".join(
        _IUPAC.get(base, "N") for base in reversed(dna_sequence)
    )


def shuffle_dna(seq: str, rng: np.random.Generator | None = None) -> str:
    """Mononucleotide-frequency-preserving random shuffle."""
    rng = rng or np.random.default_rng()
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()
    rng.shuffle(arr)
    return arr.tobytes().decode("ascii")


def kmer_shuffle(seq: str, k: int = 1,
                 rng: np.random.Generator | None = None) -> str:
    """Shuffle by breaking into non-overlapping k-mers.

    The trailing partial k-mer (if any) stays at the end, matching the
    reference (``transform.py:90-112``).
    """
    if k <= 0:
        raise ValueError("k must be >= 1")
    rng = rng or np.random.default_rng()
    kmers = [seq[i : i + k] for i in range(0, len(seq), k)]
    last = None
    if kmers and len(kmers[-1]) < k:
        last = kmers.pop()
    rng.shuffle(kmers)
    if last is not None:
        kmers.append(last)
    return "".join(kmers)


def dinuc_shuffle(seq: str, num_shufs: int | None = None, rng=None):
    """Dinucleotide-frequency-preserving shuffle (Altschul–Erickson).

    Builds the dinucleotide transition graph and samples a random Euler
    walk: for each character, the successors observed in the sequence are
    permuted with the constraint that the *last* outgoing edge of each
    vertex leads toward the terminal vertex (guaranteed here by keeping
    each vertex's final successor fixed, as in the reference
    implementation ``transform.py:114-177``).

    Returns one string, or a list of ``num_shufs`` strings.
    """
    if rng is None:
        rng = np.random.default_rng()

    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    chars, tokens = np.unique(arr, return_inverse=True)
    if len(arr) <= 2 or len(chars) == 1:
        out = [seq] * (num_shufs or 1)
        return out if num_shufs else out[0]

    # successor indices for each character (position + 1); the list is
    # UPDATED across shuffles, compounding exactly like the reference
    # (seed-for-seed identical for both Generator and RandomState rngs,
    # pinned live in tests/test_transform_live_parity.py)
    succ = [np.where(tokens[:-1] == t)[0] + 1 for t in range(len(chars))]

    results = []
    for _ in range(num_shufs or 1):
        for t in range(len(chars)):
            inds = np.arange(len(succ[t]))
            if len(inds):  # chars appearing only at the end have no succs
                inds[:-1] = rng.permutation(len(inds) - 1)
            succ[t] = succ[t][inds]
        counters = [0] * len(chars)
        ind = 0
        result = np.empty_like(tokens)
        result[0] = tokens[0]
        for j in range(1, len(tokens)):
            t = tokens[ind]
            ind = succ[t][counters[t]]
            counters[t] += 1
            result[j] = tokens[ind]
        results.append(chars[result].tobytes().decode("ascii"))
    return results if num_shufs else results[0]
