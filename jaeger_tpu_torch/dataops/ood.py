"""Copy of `jaeger_tpu/dataops/ood.py`.

Out-of-distribution (shuffled-negative) dataset building.

Parity target: reference ``dataops/ood.py:59-307`` (``OODDatasetBuilder``)
— build OOD training rows by shuffling in-distribution sequences
(mononucleotide / dinucleotide / k-mer preserving), optionally adding
synthetic tandem-repeat sequences, and optionally keeping only sequences
the classifier previously got right.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path

from jaeger_tpu_torch.seqops.fasta import read_fasta, write_fasta_entry
from jaeger_tpu_torch.seqops.synthetic import generate_random_tandem_repeats
from jaeger_tpu_torch.seqops.transform import dinuc_shuffle, kmer_shuffle, shuffle_dna


@dataclass
class SequenceRecord:
    seq_id: str
    sequence: str
    label: int


class OODDatasetBuilder:
    """Build ID(1)/OOD(0) reliability-training rows from sequences."""

    def __init__(
        self,
        input_path: str | Path,
        output_path: str | Path,
        shuffle_method: str = "dinuc",
        kmer: int = 2,
        n_shuffles: int = 1,
        tandem_repeats: int = 0,
        correct_ids: set[str] | None = None,
        seed: int = 42,
        output_format: str = "csv",
        seq_col: int = 1,
    ):
        self.input_path = Path(input_path)
        self.output_path = Path(output_path)
        self.shuffle_method = shuffle_method
        self.kmer = kmer
        self.n_shuffles = n_shuffles
        self.tandem_repeats = tandem_repeats
        self.correct_ids = correct_ids
        self.seed = seed
        self.output_format = output_format
        self.seq_col = seq_col

    def _shuffle(self, seq: str) -> str:
        if self.shuffle_method == "dinuc":
            return dinuc_shuffle(seq)
        if self.shuffle_method == "kmer":
            return kmer_shuffle(seq, k=self.kmer)
        if self.shuffle_method in ("random", "mono"):
            return shuffle_dna(seq)
        raise ValueError(f"unknown shuffle method {self.shuffle_method!r}")

    def _load(self) -> list[SequenceRecord]:
        records = []
        if self.input_path.suffix.lower() in (".fa", ".fasta", ".fna", ".gz"):
            for header, seq in read_fasta(self.input_path):
                records.append(SequenceRecord(header, seq.upper(), 1))
        else:
            # CSV: sequence column selectable (reference --seq_col,
            # cli.py:835-846)
            with open(self.input_path) as fh:
                for i, line in enumerate(fh):
                    parts = line.strip().split(",")
                    if len(parts) > self.seq_col:
                        records.append(
                            SequenceRecord(
                                f"row{i}", parts[self.seq_col].upper(), 1
                            )
                        )
        if self.correct_ids is not None:
            records = [r for r in records if r.seq_id in self.correct_ids]
        return records

    def build(self) -> dict:
        random.seed(self.seed)
        records = self._load()
        out_rows: list[SequenceRecord] = []
        for rec in records:
            out_rows.append(SequenceRecord(rec.seq_id, rec.sequence, 1))
            for s in range(self.n_shuffles):
                out_rows.append(
                    SequenceRecord(
                        f"{rec.seq_id}__shuf{s}", self._shuffle(rec.sequence), 0
                    )
                )
        if self.tandem_repeats and records:
            max_len = max(len(r.sequence) for r in records)
            for i, seq in enumerate(
                generate_random_tandem_repeats(
                    self.tandem_repeats, max_len=max_len
                )
            ):
                out_rows.append(SequenceRecord(f"tandem_{i}", seq, 0))

        if self.output_format == "csv":
            with open(self.output_path, "w") as fh:
                for r in out_rows:
                    fh.write(f"{r.label},{r.sequence}\n")
        else:
            with open(self.output_path, "w") as fh:
                for r in out_rows:
                    write_fasta_entry(fh, f"{r.seq_id}__class={r.label}",
                                      r.sequence)
        n_id = sum(1 for r in out_rows if r.label == 1)
        return {"total": len(out_rows), "id": n_id, "ood": len(out_rows) - n_id}


#: numeric label -> class-name mapping used when parsing
#: ``__class=<label>`` contig-id suffixes against a prediction TSV
#: (reference ``dataops/ood.py:30-37``)
PREDICTION_MAP = {
    "0": "bacteria", "1": "phage", "2": "eukarya",
    "3": "archaea", "4": "plasmid", "5": "virus",
}


def load_correct_predictions(predictions_path: str | Path) -> set[str]:
    """Contig ids whose Jaeger prediction matches the ``__class=``
    suffix encoded in the id (reference ``_load_correct_predictions``,
    ``dataops/ood.py:104-128``): column 0 is the contig id, column 2
    the predicted class name."""
    correct: set[str] = set()
    with open(predictions_path) as fh:
        header = fh.readline()
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or "__class=" not in parts[0]:
                continue
            contig_id, true_label = parts[0].rsplit("__class=", 1)
            true_class = PREDICTION_MAP.get(true_label, true_label)
            if true_class == parts[2]:
                correct.add(contig_id)
    return correct


def shuffle_core(input: str, output: str, method: str = "dinuc",
                 kmer: int = 2, n_shuffles: int = 1,
                 tandem_repeats: int = 0, seed: int = 42,
                 output_format: str = "csv", seq_col: int = 1,
                 class_col: int | None = None,
                 input_predictions: str | None = None) -> dict:
    """CLI entry: build a shuffled-negative OOD dataset."""
    correct_ids = (load_correct_predictions(input_predictions)
                   if input_predictions else None)
    return OODDatasetBuilder(
        input, output, shuffle_method=method, kmer=kmer,
        n_shuffles=n_shuffles, tandem_repeats=tandem_repeats, seed=seed,
        output_format=output_format, seq_col=seq_col,
        correct_ids=correct_ids,
    ).build()
