"""Copy of `jaeger_tpu/commands/utils.py`.

Data tooling commands (the ``utils`` CLI group).

Parity targets: reference ``commands/utils.py`` — ``mask_core`` (:19),
``convert_core`` (:248), ``fragment``/``split`` (``dataops/split.py:30``),
``optimize_data_core`` (:552 -> ``dataops/convert.py:1557``),
``ood_data`` (``dataops/ood.py``), plus FASTA->window-CSV fragmenting.
"""

from __future__ import annotations

import csv
import logging
import random
from pathlib import Path

import numpy as np

logger = logging.getLogger("jaeger_tpu_torch")

from jaeger_tpu_torch.seqops.fasta import read_fasta, write_fasta_entry

_ALT = {
    ord("A"): ("T", "G", "C"),
    ord("T"): ("A", "G", "C"),
    ord("G"): ("A", "T", "C"),
    ord("C"): ("A", "T", "G"),
}
_DEFAULT_ALTS = ("N", "N", "N")


def mask_core(input: str, output: str, minperc: float = 0.0,
              maxperc: float = 1.0, step: float = 0.01,
              mutate: bool = False, seed: int | None = None) -> int:
    """Progressive masking/mutation series per record.

    For each record, write one FASTA entry per masking level from
    ``minperc`` to ``maxperc``; each step masks (->N) or mutates
    (->random alternative base) an additional ``step`` fraction of fresh
    positions. Parity: reference ``commands/utils.py:19-113``, pinned
    live byte-for-byte in ``tests/test_mask_live_parity.py`` — index
    selection uses the global ``np.random`` stream like the reference
    (seeded here when *seed* is given; mutation base choices use the
    same stream, a reproducibility improvement over the reference's
    unseeded ``default_rng``).
    """
    if seed is not None:
        np.random.seed(seed)
    n_entries = 0

    def hard_mask(seq: str, indices) -> str:
        ba = bytearray(seq, "ascii")
        for i in indices:
            ba[i] = 0x4E  # 'N'
        return ba.decode("ascii")

    def replacement_mutation(seq: str, indices) -> str:
        ba = bytearray(seq, "ascii")
        choices = np.random.randint(0, 3, size=len(indices))
        for i, choice in zip(indices, choices):
            alts = _ALT.get(ba[i], _DEFAULT_ALTS)
            ba[i] = ord(alts[choice])
        return ba.decode("ascii")

    with open(output, "w") as fh:
        for name, seq in read_fasta(input):
            seq = str(seq)
            seqlen = len(seq)
            current = minperc
            used: set[int] = set()
            while current <= maxperc:
                fh.write(f">{name}_mutperc_{current * 100:.2f}\n")
                for i in range(0, len(seq), 70):
                    fh.write(seq[i : i + 70] + "\n")
                n_entries += 1
                num_mutate = int(seqlen * step)
                available = list(set(np.arange(seqlen)) - used)
                if not available:
                    break
                new_idx = np.random.choice(
                    available, min(num_mutate, len(available)), replace=False
                )
                used.update(int(i) for i in new_idx)
                seq = (
                    replacement_mutation(seq, new_idx) if mutate
                    else hard_mask(seq, new_idx)
                )
                current += step
    return n_entries


def convert_core(input: str, output: str, itype: str) -> int:
    """CSV (class,sequence,id) <-> FASTA (``>id__class=N``) conversion.

    Parity: reference ``commands/utils.py:248-293``.
    """
    itype = itype.upper()
    count = 0
    if itype == "CSV":
        with open(input) as fh, open(output, "w") as out:
            for row in csv.reader(fh):
                if len(row) < 3:
                    continue
                cls_id, seq, seq_id = (
                    row[0].strip(), row[1].strip(), row[2].strip()
                )
                out.write(f">{seq_id}__class={cls_id}\n{seq}\n")
                count += 1
    elif itype == "FASTA":
        with open(output, "w") as out:
            for name, seq in read_fasta(input):
                if "__class=" in name:
                    seq_id, cls_id = name.rsplit("__class=", 1)
                else:
                    seq_id, cls_id = name, ""
                out.write(f"{cls_id},{seq},{seq_id}\n")
                count += 1
    else:
        raise ValueError("itype must be 'CSV' or 'FASTA'")
    return count


def fragment_core(input: str, output: str, fsize: int = 2000,
                  stride: int | None = None, min_len: int | None = None,
                  label: int | None = None) -> int:
    """FASTA -> window CSV (``label,sequence`` or FASTA of fragments).

    Window grid parity with ``fragment_generator`` (reference
    ``seqops/io.py:74-147``).
    """
    from jaeger_tpu_torch.seqops.windows import window_indices

    count = 0
    is_csv = str(output).endswith(".csv")
    with open(output, "w") as out:
        for header, seq in read_fasta(input):
            seq = seq.upper()
            ml = min_len if min_len is not None else fsize
            if len(seq) >= fsize:
                for i, start in enumerate(
                    window_indices(len(seq), fsize, stride)
                ):
                    frag = seq[start : start + fsize]
                    if is_csv:
                        out.write(f"{label if label is not None else 0},{frag}\n")
                    else:
                        write_fasta_entry(out, f"{header}__w{i}", frag)
                    count += 1
            elif len(seq) >= ml:
                if is_csv:
                    out.write(f"{label if label is not None else 0},{seq}\n")
                else:
                    write_fasta_entry(out, f"{header}__w0", seq)
                count += 1
    return count


def add_topk_significance(df) -> "object":
    """Welch one-tailed p-value per contig: top-1 vs top-2 class score.

    Reference ``commands/utils.py:488-511``: mean ``*_score`` and
    ``*_var`` columns at n = total windows feed
    :func:`jaeger_tpu_torch.utils.stats.welch_t_one_tailed`; adds a ``pval``
    column.
    """
    import numpy as np

    from jaeger_tpu_torch.utils.stats import welch_t_one_tailed

    mean_cols = [c for c in df.columns
                 if c.endswith("_score") and "reliability" not in c]
    var_cols = [c for c in df.columns if c.endswith("_var")]
    win_cols = [c for c in df.columns
                if c.endswith("_windows") and "reliability" not in c]
    mean_scores = df[mean_cols].to_numpy(dtype=float)
    var_scores = df[var_cols].to_numpy(dtype=float)
    windows = df[win_cols].to_numpy(dtype=float).sum(axis=-1)
    rows = np.arange(mean_scores.shape[0])[:, None]
    top2 = np.flip(np.argsort(mean_scores, axis=-1), axis=-1)[:, :2]
    sm, sv = mean_scores[rows, top2], var_scores[rows, top2]
    pvals = []
    for means, variances, n in zip(sm, sv, windows):
        _, _, p = welch_t_one_tailed(
            mean1=means[0], var1=variances[0], n1=n,
            mean2=means[1], var2=variances[1], n2=n)
        pvals.append(p)
    df["pval"] = pvals
    return df


def stats_core(input: str, score_column: str | None = None,
               output: str | None = None) -> dict:
    """Summary statistics (and plots) over a prediction TSV.

    Parity role: reference ``commands/utils.py:300-548`` (stats_core).
    Always returns the JSON-able summary; with ``output`` also writes
    the reference's artifact set into that directory: class-percentage
    countplots (reliability- and p-value-thresholded), per-class
    reliability/entropy/energy violins, per-class score-density grid,
    length-quantile reliability violins, and
    ``jaeger_output_with_pvals.tsv`` (the input table + a Welch
    top1-vs-top2 ``pval`` column).
    """
    import pandas as pd

    df = pd.read_table(input)
    out: dict = {"rows": len(df)}
    if "prediction" in df.columns:
        out["per_class"] = df["prediction"].value_counts().to_dict()
    score_cols = [c for c in df.columns if c.endswith("_score")]
    if score_column:
        score_cols = [score_column]
    for c in score_cols:
        vals = pd.to_numeric(df[c], errors="coerce").dropna()
        if len(vals):
            out[c] = {
                "mean": float(vals.mean()), "std": float(vals.std()),
                "min": float(vals.min()), "max": float(vals.max()),
            }
    if "length" in df.columns:
        out["total_bp"] = int(df["length"].sum())

    if output is None:
        return out

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas.api.types as ptypes
    import seaborn as sns

    out_dir = Path(output)
    out_dir.mkdir(parents=True, exist_ok=True)
    sns.set_context("paper", font_scale=1.2)
    reliability_ok = ("reliability_score" in df.columns
                      and ptypes.is_numeric_dtype(df["reliability_score"]))

    def _countplot(frame, hue, path, title):
        ax = sns.countplot(data=frame, x="prediction", hue=hue,
                           palette="pastel", stat="percent")
        for patch in ax.patches:
            pct = patch.get_height()
            if pct > 0:
                ax.text(patch.get_x() + patch.get_width() / 2,
                        patch.get_height(), f"{pct:.1f}%",
                        ha="center", va="bottom", fontsize=10)
        ax.set_ylabel("Percentage")
        ax.set_xlabel("Prediction")
        ax.set_title(title)
        sns.despine()
        plt.tight_layout()
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()

    def _violin(frame, x, y, path, xlabel, title):
        ax = sns.violinplot(frame, x=x, y=y)
        sns.stripplot(frame, x=x, y=y, s=1, alpha=0.1, color="gray",
                      ax=ax)
        ax.set_ylabel(y.replace("_", " ").capitalize())
        ax.set_xlabel(xlabel)
        ax.set_title(title)
        sns.despine()
        plt.tight_layout()
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()

    if len(df) > 1:
        if reliability_ok:
            df["above_threshold"] = df["reliability_score"].apply(
                lambda x: "passed" if x >= 0.8 else "failed")
            _countplot(df, "above_threshold",
                       out_dir / "class_percentages.png",
                       "Class Distribution (%)")
            _violin(df, "prediction", "reliability_score",
                    out_dir / "reliability_scores.png", "Class",
                    "Per-class distribution of reliability scores")
        if "entropy" in df.columns:
            _violin(df, "prediction", "entropy", out_dir / "entropy.png",
                    "Class", "Per-class distribution of entropy")
        if "energy" in df.columns:
            _violin(df, "prediction", "energy", out_dir / "energy.png",
                    "Class", "Per-class distribution of energy")
        try:
            df_long = pd.melt(
                df[["contig_id", "length", "prediction"]
                   + [c for c in df.columns if c.endswith("_score")
                      and c != "reliability_score"]],
                id_vars=["contig_id", "length", "prediction"],
                var_name="score_class", value_name="scores")
            g = sns.FacetGrid(df_long, row="prediction",
                              hue="score_class", margin_titles=False,
                              height=2, aspect=3.5)
            g.map(sns.kdeplot, "scores", fill=True, common_norm=False,
                  alpha=0.2, linewidth=0.5)
            g.add_legend()
            g.set_axis_labels("Score", "Density")
            g.savefig(out_dir / "class_scores.png", dpi=150,
                      bbox_inches="tight")
            plt.close()
        except Exception as e:  # matches the reference's tolerance
            logger.warning(f"class-score grid was not created: {e}")
        if reliability_ok and "length" in df.columns:
            try:
                bins = pd.qcut(df["length"], q=5)
                labels = [f"{int(i.left)}-{int(i.right)}"
                          for i in bins.cat.categories]
                df["length_bin"] = pd.qcut(df["length"], q=5,
                                           labels=labels)
                _violin(df, "length_bin", "reliability_score",
                        out_dir / "reliability_scores_by_length.png",
                        "Length range",
                        "Length-wise (quantile) distribution of "
                        "reliability scores")
            except Exception as e:
                logger.warning(f"length-quantile plot not created: {e}")

    df = add_topk_significance(df)
    df.to_csv(out_dir / "jaeger_output_with_pvals.tsv", index=None,
              sep="\t", float_format="%.3f")
    if len(df) > 1:
        df["above_pval_threshold"] = df["pval"].apply(
            lambda x: "passed" if x <= 0.05 else "failed")
        _countplot(df, "above_pval_threshold",
                   out_dir / "class_percentages_pval.png",
                   "Class Distribution (%)")
    out["pvals_tsv"] = str(out_dir / "jaeger_output_with_pvals.tsv")
    return out


def _iter_dataset_records(input: str, seq_col: int | None,
                          class_col: int | None, default_label: int):
    """(sequence, label) records from FASTA or CSV input.

    CSV input with explicit column indices mirrors the reference's
    ``--seq_col``/``--class_col`` selectors (reference
    ``commands/utils.py:116-132``, ``cli.py:1027-1039``).
    """
    path = Path(input)
    if path.suffix.lower() == ".csv" or seq_col is not None:
        sc = 1 if seq_col is None else int(seq_col)
        with open(path) as fh:
            for row in csv.reader(fh):
                if len(row) <= sc:
                    continue
                lbl = default_label
                if class_col is not None and len(row) > class_col:
                    try:
                        lbl = int(row[class_col])
                    except ValueError:
                        continue
                yield row[sc].upper(), lbl
    else:
        for _header, seq in read_fasta(input):
            yield seq.upper(), default_label


def _mmseqs_dedupe(frags: list, mmseqs_bin: str, maxiden: float,
                   maxcov: float) -> list:
    """Dereplicate fragments with a real mmseqs2 binary
    (``easy-cluster --min-seq-id maxiden -c maxcov``), keeping cluster
    representatives — the reference's exact dereplication semantics
    (``commands/utils.py:170``, ``dataops/dataset.py:74-129``) when the
    binary is available (``--mmseqs-bin``). Raises FileNotFoundError
    with a pointer to the MinHash fallback when it isn't.
    """
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    binpath = shutil.which(mmseqs_bin) or (
        mmseqs_bin if Path(mmseqs_bin).exists() else None)
    if binpath is None:
        raise FileNotFoundError(
            f"mmseqs binary {mmseqs_bin!r} not found; install mmseqs2 or "
            f"drop --mmseqs-bin to use the in-repo MinHash dereplication")
    if not frags:
        return []
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        fa = td / "frags.fasta"
        with fa.open("w") as fh:
            for i, (_lab, frag) in enumerate(frags):
                fh.write(f">f{i}\n{frag}\n")
        proc = subprocess.run(
            [binpath, "easy-cluster", str(fa), str(td / "clu"),
             str(td / "tmp"), "--min-seq-id", str(maxiden),
             "-c", str(maxcov)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"mmseqs easy-cluster failed (exit {proc.returncode}): "
                f"{(proc.stderr or proc.stdout).strip()[-2000:]}")
        reps = set()
        rep_fa = td / "clu_rep_seq.fasta"
        for line in rep_fa.read_text().splitlines():
            if line.startswith(">"):
                reps.add(int(line[2:].split()[0]))
    return [f for i, f in enumerate(frags) if i in reps]


def dataset_core(input: str, out_prefix: str, frag_len: int = 2048,
                 overlap: int = 1024, trainperc: float = 0.8,
                 valperc: float = 0.1, testperc: float = 0.1,
                 label: int = 0, seed: int = 42,
                 dedupe: bool | str = "minhash",
                 dedupe_threshold: float = 0.8,
                 seq_col: int | None = None,
                 class_col: int | None = None,
                 method: str = "ANI",
                 mmseqs_bin: str | None = None,
                 maxcov: float = 0.6,
                 outtype: str = "CSV") -> dict:
    """Build a train/val/test fragment dataset from genomes.

    Parity role: reference ``commands/utils.py:226-246`` (``dataset_core``)
    which fragments genomes, dereplicates with the external mmseqs2
    binary, and splits. ``dedupe='minhash'`` (default) clusters with
    canonical-k-mer MinHash sketches at ``dedupe_threshold`` estimated
    Jaccard — the in-repo equivalent of mmseqs2 identity clustering
    (dataops/dedupe.py), no external binary; fidelity vs exact-identity
    clustering is quantified in docs/fidelity.md. ``mmseqs_bin`` routes
    dereplication through a real mmseqs2 binary instead (the
    reference's exact semantics, with separate identity/coverage
    knobs). ``'exact'`` keeps the cheap endpoint-signature dedupe;
    ``False`` disables. CSV input uses ``seq_col``/``class_col``
    (per-row labels override ``label``).
    """
    rng = random.Random(seed)
    frags: list[tuple[int, str]] = []
    seen: set[int] = set()
    deduper = None
    if mmseqs_bin and dedupe is not False and dedupe != "none":
        deduper = None          # collect everything, cluster below
        dedupe = "mmseqs"
    elif mmseqs_bin:
        logger.warning(
            "--mmseqs-bin given but dereplication is disabled "
            "(--dedupe none); skipping mmseqs clustering")
    elif dedupe == "minhash" or dedupe is True:
        from jaeger_tpu_torch.dataops.dedupe import MinHashDeduper

        deduper = MinHashDeduper(threshold=dedupe_threshold,
                                 mode=("aa" if str(method).upper() == "AAI"
                                       else "nt"))
    for seq, rec_label in _iter_dataset_records(
        input, seq_col, class_col, label
    ):
        for start in range(0, max(1, len(seq) - frag_len + 1),
                           max(1, frag_len - overlap)):
            frag = seq[start : start + frag_len]
            if len(frag) < frag_len // 2:
                continue
            if deduper is not None:
                if deduper.is_duplicate(frag):
                    continue
            elif dedupe == "exact":
                sig = hash(frag[:256] + frag[-256:])
                if sig in seen:
                    continue
                seen.add(sig)
            frags.append((rec_label, frag))
    if dedupe == "mmseqs":
        frags = _mmseqs_dedupe(frags, mmseqs_bin, dedupe_threshold, maxcov)
    rng.shuffle(frags)
    n = len(frags)
    n_train = int(n * trainperc)
    n_val = int(n * valperc)
    splits = {
        "train": frags[:n_train],
        "val": frags[n_train : n_train + n_val],
        "test": frags[n_train + n_val :],
    }
    if str(outtype).upper() == "FASTA":
        for name, rows in splits.items():
            with open(f"{out_prefix}_{name}.fasta", "w") as fh:
                for i, (rec_label, frag) in enumerate(rows):
                    fh.write(f">{name}_{i}_class_{rec_label}\n{frag}\n")
    else:
        for name, rows in splits.items():
            with open(f"{out_prefix}_{name}.csv", "w") as fh:
                for rec_label, frag in rows:
                    fh.write(f"{rec_label},{frag}\n")
    return {k: len(v) for k, v in splits.items()}


def optimize_data_core(input: str, output: str, format: str = "translated",
                       units: str = "nuc", overlap: float | None = None,
                       **kwargs) -> dict:
    """CSV -> NPZ conversion entry (reference ``commands/utils.py:552``).

    ``units='codon'`` converts crop sizes through the crop contract
    (``3*codons + 5``) and scales strides by 3; ``overlap`` (fraction of
    each crop) overrides stride (reference ``commands/utils.py:634-650``).
    """
    from jaeger_tpu_torch.dataops.convert import convert_dataset

    crop_size = kwargs.get("crop_size", 500)
    if isinstance(crop_size, int):
        crop_size = [crop_size]
    crop_size = [int(c) for c in crop_size]
    if units not in ("nuc", "codon"):
        raise ValueError("units must be 'nuc' or 'codon'")
    if units == "codon":
        from jaeger_tpu_torch.seqops.crop import codons_to_nucleotides

        crop_size = [codons_to_nucleotides(c) for c in crop_size]
        kwargs["stride"] = int(kwargs.get("stride", 0)) * 3
        if kwargs.get("strides") is not None:
            kwargs["strides"] = [s * 3 for s in kwargs["strides"]]
    if kwargs.get("strides") is None and overlap is not None:
        kwargs["strides"] = [int(cs * (1 - overlap)) for cs in crop_size]
    kwargs["crop_size"] = crop_size
    return convert_dataset(input, output, format=format, **kwargs)
