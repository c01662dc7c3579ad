"""Copy of `jaeger_tpu/seqops/fasta.py`.

Streaming FASTA reading/writing.

Replaces the reference's pyfastx C dependency (used at
``seqops/io.py:98`` and throughout) with a zero-dependency streaming
parser. Plain and gzip-compressed files are supported. A C++ fast path
(:mod:`jaeger_tpu_torch.native`) takes over for bulk ingest when built; this
module is the always-available fallback and the behavioural oracle.
"""

from __future__ import annotations

import gzip
import io
import os
from pathlib import Path
from typing import Iterator


def _open_text(path: str | os.PathLike) -> io.TextIOBase:
    p = str(path)
    fh = open(p, "rb")
    magic = fh.read(2)
    fh.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=fh), encoding="ascii")
    return io.TextIOWrapper(fh, encoding="ascii")


def read_fasta(path: str | os.PathLike) -> Iterator[tuple[str, str]]:
    """Yield ``(header, sequence)`` records from a FASTA(.gz) file.

    The header is the full line after ``>`` (whitespace-stripped, like
    pyfastx's full-name mode used by the reference); the sequence keeps its
    original case (masking decisions happen downstream).
    """
    header: str | None = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].strip()
                chunks = []
            elif header is not None:
                chunks.append(line)
        if header is not None:
            yield header, "".join(chunks)


def count_fasta(path: str | os.PathLike, min_len: int = 2048) -> tuple[int, int]:
    """Count total records and records with length >= ``min_len``."""
    total = 0
    above = 0
    for _, seq in read_fasta(path):
        total += 1
        if len(seq) >= min_len:
            above += 1
    return total, above


def validate_fasta_entries(path: str | os.PathLike, min_len: int = 2048) -> int:
    """Validate a FASTA file: at least one record must reach ``min_len``.

    Parity with reference ``seqops/io.py:296-312`` — raises when every
    record is shorter than ``min_len``; returns the total record count.
    """
    try:
        total, above = count_fasta(path, min_len)
    except UnicodeDecodeError as e:
        raise ValueError(
            f"{path} is not a FASTA file (binary/non-ASCII content)"
        ) from e
    if total == 0:
        raise ValueError(f"{path} contains no FASTA records")
    if above == 0:
        raise ValueError(f"all records in {path} are < {min_len}bp")
    return total


def write_fasta_entry(fh, header: str, seq: str, width: int = 70) -> None:
    """Write one record with fixed line width."""
    fh.write(f">{header}\n")
    for i in range(0, len(seq), width):
        fh.write(seq[i : i + width] + "\n")


def write_fasta(records, path: str | os.PathLike, width: int = 70) -> None:
    with open(path, "w") as fh:
        for header, seq in records:
            write_fasta_entry(fh, header, seq, width)


def split_fasta(path: str | os.PathLike, output_dir: str | os.PathLike,
                chunks: int) -> list[Path]:
    """Split a FASTA into ``chunks`` round-robin chunk files.

    Role parity: reference ``seqops/io.py:320-368`` (pyfastx split);
    empty chunks are removed.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(path).stem
    paths = [output_dir / f"{stem}.{i:03d}.fasta" for i in range(chunks)]
    handles = [open(p, "w") for p in paths]
    try:
        for i, (header, seq) in enumerate(read_fasta(path)):
            write_fasta_entry(handles[i % chunks], header, seq)
    finally:
        for fh in handles:
            fh.close()
    kept = []
    for p in paths:
        if p.stat().st_size == 0:
            p.unlink()
        else:
            kept.append(p)
    return kept


def fasta_stem(path) -> str:
    """Base name with FASTA extensions stripped (handles ``.fasta.gz``)."""
    from pathlib import Path

    name = Path(path).name
    if name.endswith(".gz"):
        name = name[:-3]
    for ext in (".fasta", ".fa", ".fna", ".ffn", ".frn"):
        if name.endswith(ext):
            return name[: -len(ext)]
    return Path(name).stem
