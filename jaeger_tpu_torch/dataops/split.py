"""Copy of `jaeger_tpu/dataops/split.py`.

Metagenomic fragment sampling (genome splitting / assembly simulation).

Parity target: reference ``dataops/split.py:30-169`` — two modes, pinned
live seed-for-seed byte-identical in ``tests/test_split_live_parity.py``:

1. sequential tiling (no coverage): walk each genome with
   ``randint(minlen, maxlen)`` fragment lengths and fixed overlap;
2. coverage-based random sampling: draw random-start fragments until the
   ACCEPTED bases reach ``coverage * genome_length`` (rejected fragments
   don't count), with optional circular wrap-around.

Headers are ``{name}_frag{id}_start{start}_len{len}[_cov{coverage}]``
with 60-column wrapped sequence, as upstream.
"""

from __future__ import annotations

import random

import numpy as np

from jaeger_tpu_torch.seqops.fasta import read_fasta
from jaeger_tpu_torch.seqops.transform import dinuc_shuffle


def _sample_fragment(seq: str, frag_len: int, circular: bool):
    """Random-start fragment; circular mode wraps past the end
    (reference ``split.py:78-101``, RNG stream-identical)."""
    G = len(seq)
    if frag_len > G:
        frag_len = G
    if circular:
        start = random.randint(0, G - 1)
        end = start + frag_len
        if end <= G:
            fragment = seq[start:end]
        else:
            fragment = seq[start:] + seq[: end - G]
    else:
        start = random.randint(0, G - frag_len)
        fragment = seq[start : start + frag_len]
    return start, fragment


def _write_record(fh, header: str, fragment: str) -> None:
    fh.write(header)
    for i in range(0, len(fragment), 60):
        fh.write(fragment[i : i + 60] + "\n")


def split_core(
    input: str,
    output: str,
    minlen: int = 2000,
    maxlen: int = 50000,
    overlap: int = 0,
    coverage: float | None = None,
    circular: bool = False,
    max_n_prop: float = 0.3,
    seed: int | None = None,
    shuffle: bool = False,
) -> int:
    """Sample fragments from genomes into a FASTA; returns fragment count.

    Seeds the global RNG streams when *seed* is given — with ``shuffle``
    this also makes the dinucleotide shuffle reproducible (the reference
    shuffles with a fresh unseeded RandomState; documented improvement).
    """
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
    if minlen <= 0 or maxlen < minlen:
        raise ValueError("Invalid minlen/maxlen: ensure 0 < minlen <= maxlen")

    count = 0
    with open(output, "w") as fh:
        for name, seq in read_fasta(input):
            seq = str(seq)
            if shuffle:
                seq = dinuc_shuffle(seq, rng=np.random)

            genome_len = len(seq)
            frag_id = 0
            if genome_len < minlen:
                continue

            if coverage is not None:
                target_bases = coverage * genome_len
                bases_so_far = 0
                while bases_so_far < target_bases:
                    frag_len = min(random.randint(minlen, maxlen),
                                   genome_len)
                    start, fragment = _sample_fragment(
                        seq, frag_len, circular)
                    n_prop = fragment.count("N") / len(fragment)
                    if n_prop <= max_n_prop and len(fragment) >= minlen:
                        _write_record(
                            fh,
                            f">{name}_frag{frag_id}_start{start}_"
                            f"len{len(fragment)}_cov{coverage}\n",
                            fragment,
                        )
                        bases_so_far += len(fragment)
                        frag_id += 1
                        count += 1
            else:
                start = 0
                while start < genome_len:
                    frag_len = random.randint(minlen, maxlen)
                    end = min(start + frag_len, genome_len)
                    fragment = seq[start:end]
                    n_prop = (
                        fragment.count("N") / len(fragment)
                        if fragment else 1.0
                    )
                    if n_prop <= max_n_prop and len(fragment) >= minlen:
                        _write_record(
                            fh,
                            f">{name}_frag{frag_id}_start{start}_"
                            f"len{len(fragment)}\n",
                            fragment,
                        )
                        count += 1
                    if end == genome_len:
                        break
                    start = end - overlap
                    frag_id += 1
    return count
