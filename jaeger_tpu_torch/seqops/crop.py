"""Copy of `jaeger_tpu/seqops/crop.py`.

The codon <-> nucleotide crop contract.

Parity target: ``src/jaeger/seqops/crop.py`` in the reference. The whole
pipeline (training, inference, dataset conversion) pins to one arithmetic
fact: a nucleotide crop of ``3*codons + 5`` produces exactly ``codons``
positions in each of the 6 reading frames under both of the reference's
implementations (the TF ngram/offset-LUT path and the ``nt//3 - 1`` numpy
path). jaeger-tpu's device encoder (:mod:`jaeger_tpu_torch.ops.encode`) uses the
same arithmetic so checkpoints and outputs stay comparable.
"""

from __future__ import annotations

#: Codon (ngram) width of the translated encoding.
NGRAM_WIDTH = 3

#: Offset lookup used by the frame slicing: ``OFFSET_LUT[crop_size % 3]``.
#: Mirrors the TF preprocessor's ``offset_lut = [-2, -1, 0]``
#: (reference ``seqops/encode.py:115``).
OFFSET_LUT = (-2, -1, 0)


def codons_to_nucleotides(codons: int) -> int:
    """Nucleotide crop that yields exactly ``codons`` frame positions."""
    if not isinstance(codons, int) or codons <= 0:
        raise ValueError(f"codons must be a positive integer, got {codons!r}")
    return NGRAM_WIDTH * codons + 5


def nucleotides_to_codons(nucleotides: int) -> int:
    """Inverse of :func:`codons_to_nucleotides`."""
    if not isinstance(nucleotides, int) or nucleotides <= 0:
        raise ValueError(
            f"nucleotides must be a positive integer, got {nucleotides!r}"
        )
    return (nucleotides - 5) // NGRAM_WIDTH


def frame_length(valid_nt: int, crop_size: int | None = None) -> int:
    """Frame positions produced for a window with ``valid_nt`` real bases.

    Replicates the TF slice arithmetic (reference ``seqops/encode.py:157-162``
    and ``seqops/crop.py:44-61``): with ``offset = OFFSET_LUT[C % 3]`` where
    ``C`` is the configured crop (or the sequence length when cropping is
    off), every frame slice ``tri[f : -(3-f) + f? ...]`` yields
    ``ceil((valid_nt - 5 + offset + 3) / 3) - 1`` == ``ceil((m - 5 + offset)/3)``
    positions (identical for all six frames).
    """
    m = int(valid_nt)
    ref = int(crop_size) if crop_size else m
    offset = OFFSET_LUT[ref % NGRAM_WIDTH]
    usable = m - 5 + offset
    if usable <= 0:
        return 0
    return -(-usable // NGRAM_WIDTH)


def numpy_frame_length(nucleotides: int) -> int:
    """Frame positions produced by the array converter (``nt // 3 - 1``).

    Mirrors the reference's numba converter arithmetic
    (``dataops/convert.py`` / ``seqops/crop.py:64-67``).
    """
    return max(0, int(nucleotides) // NGRAM_WIDTH - 1)


def resolve_crop(string_processor: dict) -> tuple[int, int]:
    """Resolve ``(codons, nucleotides)`` from a ``string_processor`` config.

    ``crop_units`` defaults to ``"codon"`` (reference ``seqops/crop.py:70-88``).
    """
    if "crop_size" not in string_processor:
        raise ValueError("string_processor config must define 'crop_size'")
    size = string_processor["crop_size"]
    if not isinstance(size, int) or size <= 0:
        raise ValueError(f"crop_size must be a positive integer, got {size!r}")
    units = string_processor.get("crop_units", "codon")
    if units == "codon":
        return size, codons_to_nucleotides(size)
    if units == "nucleotide":
        return nucleotides_to_codons(size), size
    raise ValueError(f"crop_units must be 'codon' or 'nucleotide', got {units!r}")
