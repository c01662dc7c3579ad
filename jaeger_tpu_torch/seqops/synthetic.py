"""Copy of `jaeger_tpu/seqops/synthetic.py`.

Synthetic / corrupted sequence generators for OOD training data.

Behavioral parity target: reference ``seqops/synthetic.py`` (generators)
and its use from ``dataops/synthetic_perturbations.py:319``.  The RNG
*draw stream* (which ``random.*`` calls happen, in what order, with what
arguments) is pinned seed-for-seed by ``tests/test_synthetic_live_parity``
— so every function below consumes randomness exactly like the reference
does, while the surrounding computation is structured independently
(tiling, run-partitioning and placement are done with prefix-offset
arithmetic rather than the reference's cursor walks).
"""

from __future__ import annotations

import itertools
import random

import numpy as np

from jaeger_tpu_torch.seqops.stats import shannon_entropy
from jaeger_tpu_torch.seqops.transform import dinuc_shuffle, kmer_shuffle

_DNA = "ACGT"


# ---------------------------------------------------------------------------
# whole-sequence generators
# ---------------------------------------------------------------------------

def generate_homopolymer(length: int, base: str = "A") -> str:
    return base * length


def generate_tandem_repeat(motif: str, copies: int) -> str:
    return motif * copies


def generate_random_tandem_repeats(
    num_sequences: int,
    motif_length_range: tuple = (3, 30),
    copy_number: int = 2000,
    alphabet=tuple(_DNA),
    max_len: int = 2048,
) -> list[str]:
    """*num_sequences* random-motif tandem repeats, each capped at *max_len*."""
    out = []
    for _ in range(num_sequences):
        motif_len = random.randint(*motif_length_range)
        motif = "".join(random.choices(alphabet, k=motif_len))
        out.append(generate_tandem_repeat(motif, copy_number)[:max_len])
    return out


def generate_biased_sequence(length: int, freqs: dict | None = None) -> str:
    freqs = freqs or {"A": 0.7, "C": 0.1, "G": 0.1, "T": 0.1}
    return "".join(
        random.choices(list(freqs), weights=list(freqs.values()), k=length)
    )


def generate_low_entropy_sequence(length: int, window_size: int,
                                  threshold: float,
                                  max_attempts: int = 10000) -> str:
    """Rejection-sample a biased sequence whose every *window_size* slice
    stays under the entropy *threshold*."""
    n_windows = length - window_size + 1
    for _ in range(max_attempts):
        seq = generate_biased_sequence(length)
        if all(shannon_entropy(seq[i:i + window_size]) < threshold
               for i in range(n_windows)):
            return seq
    raise ValueError(
        f"failed to generate a low-entropy sequence in {max_attempts} tries"
    )


# ---------------------------------------------------------------------------
# shared internals
# ---------------------------------------------------------------------------

def _pick_window(seq_len: int, window_fraction: float) -> tuple[int, int]:
    """Uniform-start window spanning *window_fraction* of the sequence."""
    span = max(1, int(seq_len * window_fraction))
    lo = random.randint(0, max(0, seq_len - span))
    return lo, lo + span


def _tile(unit: str, width: int) -> str:
    """Repeat *unit* cyclically until exactly *width* characters."""
    reps = -(-width // len(unit))  # ceil division
    return (unit * reps)[:width]


def _split_total_into_runs(total: int, runs: int) -> list[int]:
    """Partition *total* into *runs* strictly-positive integers.

    Draw-stream compatible with the reference's sequential scheme: run i
    takes ``randint(1, left - still_reserved)`` where *still_reserved*
    holds back one unit for each later run; the final run absorbs the
    remainder.
    """
    left = total
    sizes: list[int] = []
    for still_reserved in range(runs - 1, 0, -1):
        take = random.randint(1, left - still_reserved)
        sizes.append(take)
        left -= take
    sizes.append(left)
    return sizes


# ---------------------------------------------------------------------------
# windowed perturbations
# ---------------------------------------------------------------------------

def apply_shuffle(seq: str) -> str:
    chars = list(seq)
    random.shuffle(chars)
    return "".join(chars)


def apply_dinuc_shuffle(seq: str) -> str:
    # Intentional improvement over the reference: its apply_dinuc_shuffle
    # constructs a FRESH np.random.RandomState (transform.py:112-131),
    # so reference reliability datasets using dinuc mode are
    # irreproducible even under its own chunk seeding.  Routing through
    # the global np.random stream makes our generation deterministic
    # under the chunk seed (pinned in tests/test_synthetic_live_parity).
    return dinuc_shuffle(seq, rng=np.random)


def apply_kmer_shuffle(seq: str, k: int = 2) -> str:
    # Same reproducibility fix: the reference's kmer_shuffle uses an
    # unseeded np.random.default_rng() (transform.py:88-106).
    return kmer_shuffle(seq, k=k, rng=np.random)


def apply_subseq_repeat_window(seq: str, window_fraction: float = 0.25) -> str:
    """Overwrite a random window by cycling a random slice of *seq* itself."""
    if not seq:
        return seq
    lo, hi = _pick_window(len(seq), window_fraction)
    take = random.randint(1, min(hi - lo, len(seq)))
    at = random.randint(0, len(seq) - take)
    return seq[:lo] + _tile(seq[at:at + take], hi - lo) + seq[hi:]


def apply_tandem_repeat_window(
    seq: str,
    motif_length_range: tuple[int, int] = (3, 10),
    window_fraction: float = 0.25,
    num_repeats: int | None = None,
) -> str:
    """Overwrite a random window by cycling a random short motif.

    With *num_repeats*, the cycled unit is the motif pre-repeated that
    many times (reference semantics — affects only truncation phase).
    """
    if not seq:
        return seq
    lo, hi = _pick_window(len(seq), window_fraction)
    motif = "".join(
        random.choices(_DNA, k=random.randint(*motif_length_range))
    )
    unit = motif * num_repeats if num_repeats and num_repeats > 0 else motif
    return seq[:lo] + _tile(unit, hi - lo) + seq[hi:]


def apply_n_stretch(
    seq: str,
    n_fraction_range: tuple[float, float] = (0.3, 1.0),
    max_stretches: int = 3,
    point_n_share: float = 0.2,
) -> str:
    """Mask a sampled fraction of *seq* with Ns.

    The N budget splits into contiguous runs (1..*max_stretches*, placed
    non-overlapping) plus a *point_n_share* tail of scattered single
    positions.  Run placement: the sampled ``cuts`` index positions in
    the *kept* (non-run) subsequence, so run *i* lands at absolute offset
    ``cuts[i] + len(runs before it)`` — no cursor walk needed.
    """
    if not seq:
        return seq
    seq_len = len(seq)
    fraction = random.uniform(*n_fraction_range)
    budget = min(seq_len, max(1, round(seq_len * fraction)))
    scatter = min(budget, round(budget * point_n_share))
    run_total = budget - scatter

    out = np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()
    if run_total > 0:
        n_runs = random.randint(1, max(1, min(max_stretches, run_total)))
        run_lens = _split_total_into_runs(run_total, n_runs)
        kept = seq_len - run_total
        cuts = sorted(random.choices(range(kept + 1), k=n_runs))
        run_starts = (
            np.fromiter(cuts, dtype=np.int64)
            + np.fromiter(itertools.accumulate([0] + run_lens[:-1]),
                          dtype=np.int64, count=n_runs)
        )
        for at, width in zip(run_starts, run_lens):
            out[at:at + width] = ord("N")
    if scatter > 0:
        open_idx = np.flatnonzero(out != ord("N"))
        hit = random.sample(list(open_idx), k=min(scatter, open_idx.size))
        out[np.asarray(hit, dtype=np.int64)] = ord("N")
    return out.tobytes().decode("ascii")


def apply_mix(sequences: list[str], output_length: int | None = None,
              pad_value: str = "N") -> str:
    """Chimeric mix: one random subsegment per source sequence.

    Reference semantics (RNG stream-identical): without *output_length*
    the sources concatenate whole.  Otherwise ``n-1`` sorted sample marks
    partition the output length into per-source budgets (degenerate
    *output_length* < n: one base each for sources 1..output_length),
    each source contributes a random-start slice of at most its budget,
    and the result is right-padded with *pad_value*.
    """
    if not sequences:
        raise ValueError("apply_mix requires at least one sequence")
    if output_length is not None and output_length < 0:
        raise ValueError("output_length must be non-negative")
    if output_length is None:
        return "".join(sequences)
    if output_length == 0:
        return ""

    n = len(sequences)
    if output_length < n:
        budgets = [0] + [1] * output_length + [0] * (n - output_length - 1)
    else:
        edges = [0, *sorted(random.sample(range(output_length), k=n - 1)),
                 output_length]
        budgets = [b - a for a, b in zip(edges, edges[1:])]

    pieces = []
    for src, budget in zip(sequences, budgets):
        if not src or budget <= 0:
            continue
        width = min(budget, len(src))
        at = random.randint(0, len(src) - width)
        pieces.append(src[at:at + width])

    chimera = "".join(pieces)
    return chimera + pad_value * max(0, output_length - len(chimera))
