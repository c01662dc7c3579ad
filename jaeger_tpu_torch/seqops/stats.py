"""Copy of `jaeger_tpu/seqops/stats.py`.

Simple per-sequence statistics.

Parity target: reference ``seqops/stats.py``.
"""

from __future__ import annotations

import math
from collections import Counter


def shannon_entropy(seq: str) -> float:
    """Shannon entropy (bits) of the character distribution."""
    if not seq:
        return 0.0
    counts = Counter(seq)
    n = len(seq)
    return -sum(
        (c / n) * math.log2(c / n) for c in counts.values()
    )


def gc_content(sequence: str) -> float:
    if not sequence:
        return 0.0
    return (sequence.count("G") + sequence.count("C")) / len(sequence)


def percentage_of_n(sequence: str) -> float:
    if not sequence:
        return 0.0
    return sequence.count("N") / len(sequence)


def gc_skew(seq: str) -> float:
    g = seq.count("G")
    c = seq.count("C")
    return (g - c) / (g + c) if (g + c) else 0.0
