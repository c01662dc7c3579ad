"""Copy of `jaeger_tpu/postprocess/collect.py`.

Window -> contig reduction and TSV writers.

Parity targets: reference ``postprocess/collect.py:247-640``
(``pred_to_dict`` / ``generate_summary`` / ``write_output``). The TPU
redesign takes the structured window metadata
(:class:`jaeger_tpu_torch.seqops.windows.WindowBatch` fields concatenated across
batches) instead of parsing ``meta_N`` string tensors, but produces the
same per-contig statistics, column set, and float formatting so TSVs are
comparable line-for-line. ``pandas`` is imported inside the functions
that build tables, so the model path imports without it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from jaeger_tpu_torch.postprocess import helpers as H


@dataclass
class PredictionMeta:
    """Concatenated per-window metadata in model-output order."""

    headers: np.ndarray      # (n,) contig id per window (str)
    contig_end: np.ndarray   # (n,) int8
    seqlen: np.ndarray       # (n,) int32
    g: np.ndarray
    c: np.ndarray
    a: np.ndarray
    t: np.ndarray
    gc_skew: np.ndarray
    start: np.ndarray | None = None
    length: np.ndarray | None = None   # valid bases per window

    @classmethod
    def from_batches(cls, batches) -> "PredictionMeta":
        def cat(field):
            return np.concatenate([getattr(b, field) for b in batches])

        headers = np.concatenate(
            [np.asarray(b.headers, dtype=object)[b.contig] for b in batches]
        )
        return cls(
            headers=headers,
            contig_end=cat("contig_end"),
            seqlen=cat("seqlen"),
            g=cat("g"), c=cat("c"), a=cat("a"), t=cat("t"),
            gc_skew=cat("gc_skew"),
            start=cat("start"),
            length=cat("length"),
        )


def reduce_windows(
    prediction: np.ndarray,
    meta: PredictionMeta,
    fsize: int,
    num_classes: int,
    reliability: np.ndarray | None = None,
    class_names: list[str] | None = None,
    crf_switch_cost: float | None = None,
    crf_prior: str = "biological",
    crf_transition_matrix: dict | None = None,
    term_repeats: pd.DataFrame | None = None,
) -> tuple[dict, dict]:
    """Reduce per-window logits to per-contig statistics.

    Parity: ``pred_to_dict`` (reference ``collect.py:247-435``): float16
    summary stats, argmax or CRF-Viterbi window labels, entropy/energy,
    reliability = fraction of windows with sigmoid > 0.5, contamination
    heuristics.
    """
    split_flags = np.asarray(meta.contig_end, dtype=np.int32)
    split_indices = np.where(split_flags == 1)[0] + 1
    if len(split_indices) and prediction.shape[0] == split_indices[-1]:
        split_indices = split_indices[:-1]

    classifier_type = "binary" if prediction.shape[-1] == 1 else "softmax"

    crf_costs = None
    if crf_switch_cost is not None and class_names:
        crf_costs = H.build_transition_costs(
            class_names, switch_cost=crf_switch_cost, prior=crf_prior,
            user_matrix=crf_transition_matrix,
        )

    predictions = np.split(prediction, split_indices, axis=0)
    ood = (
        np.split(reliability, split_indices, axis=0)
        if reliability is not None
        else None
    )

    headers = np.array(
        [h[0] for h in np.split(np.asarray(meta.headers, dtype=str), split_indices)]
    )
    lengths = np.array(
        [s[0] for s in np.split(np.asarray(meta.seqlen, np.int32), split_indices)]
    )
    gc_skews = np.split(np.asarray(meta.gc_skew, float), split_indices)

    a, t, g, c = (np.asarray(v, float) for v in (meta.a, meta.t, meta.g, meta.c))
    ns = (fsize - (a + t + g + c)) / fsize
    gcs = (g + c) / fsize
    ns = np.split(ns, split_indices)
    gcs = np.split(gcs, split_indices)

    pred_sum = np.array(
        [np.squeeze(np.mean(p, axis=0)) for p in predictions], dtype=np.float16
    )
    pred_var = np.array(
        [np.squeeze(np.var(p, axis=0)) for p in predictions], dtype=np.float16
    )

    if classifier_type == "softmax":
        entropy_pred = [H.softmax_entropy(p) for p in predictions]
        energy_pred = [H.energy(p) for p in predictions]
        consensus = np.argmax(pred_sum, axis=1)
        if crf_switch_cost is not None:
            frag_pred = [
                H.viterbi_decode(p, crf_switch_cost, crf_costs)
                for p in predictions
            ]
        else:
            frag_pred = [np.argmax(p, axis=-1) for p in predictions]
        per_class_counts = [
            H.update_dict(np.unique(fp, return_counts=True), num_classes)
            for fp in frag_pred
        ]
        prophage_contam = (pred_sum[:, 1] < pred_var[:, 1]) & (consensus == 0)
        host_contam = (pred_sum[:, 1] < pred_var[:, 1]) & (consensus == 1)
    else:
        # Intentional divergence from the reference (collect.py:360):
        # the reference feeds RAW logits into binary_entropy, whose
        # [eps, 1-eps] clip treats them as probabilities — any logit
        # outside (0, 1) collapses to ~0 entropy. We apply sigmoid first
        # so the column is the actual Bernoulli entropy of the window
        # probability. Pinned by tests/test_postprocess.py
        # (test_binary_entropy_uses_sigmoid_probabilities).
        entropy_pred = [H.binary_entropy(H.sigmoid(p)) for p in predictions]
        energy_pred = [H.energy(p) for p in predictions]
        consensus = np.array([H.sigmoid(p) for p in pred_sum])
        consensus = (consensus > 0.5).astype(float)
        if crf_switch_cost is not None:
            frag_pred = [
                H.viterbi_decode(
                    np.concatenate([np.zeros_like(p), p], axis=-1),
                    crf_switch_cost,
                )
                for p in predictions
            ]
        else:
            frag_pred = [(H.sigmoid(p) > 0.5).astype(int) for p in predictions]
        per_class_counts = [
            H.update_dict(np.unique(fp, return_counts=True), num_classes)
            for fp in frag_pred
        ]
        prophage_contam = (pred_sum < pred_var) & (consensus == 0)
        host_contam = (pred_sum < pred_var) & (consensus == 1)

    if ood is not None:
        ood = np.array(
            [_frac_above(H.sigmoid(p)) for p in ood], dtype=np.float16
        )

    entropy_mean = np.array(
        [np.squeeze(np.mean(e)) for e in entropy_pred], dtype=np.float16
    )
    energy_mean = np.array(
        [np.squeeze(np.mean(e)) for e in energy_pred], dtype=np.float16
    )

    data = {
        "headers": headers,
        "length": lengths,
        "consensus": consensus,
        "per_class_counts": per_class_counts,
        "pred_sum": pred_sum,
        "pred_var": pred_var,
        "frag_pred": frag_pred,
        "ood": ood,
        "has_reliability": reliability is not None,
        "entropy": entropy_mean,
        "energy": energy_mean,
        "host_contam": host_contam,
        "prophage_contam": prophage_contam,
        "repeats": term_repeats,
        "gc": gcs,
        "ns": ns,
    }
    data_full = {
        "predictions": predictions,
        "headers": headers,
        "lengths": lengths,
        "gc_skews": gc_skews,
        "gcs": gcs,
        "starts": (
            np.split(np.asarray(meta.start), split_indices)
            if meta.start is not None else None
        ),
    }
    return _two_pass_order(data, fsize), _two_pass_order(data_full, fsize)


def data_from_device_stats(
    stats: dict[int, dict],
    meta: PredictionMeta,
    fsize: int,
    num_classes: int,
    with_reliability: bool,
    term_repeats: pd.DataFrame | None = None,
) -> dict:
    """Build the ``pred_to_dict``-shaped data dict from on-device
    per-contig statistics (:mod:`jaeger_tpu_torch.ops.reduce`).

    The device path supports the argmax decoding mode; CRF smoothing and
    the full-logit auxiliary outputs use :func:`reduce_windows`.
    """
    split_flags = np.asarray(meta.contig_end, dtype=np.int32)
    split_indices = np.where(split_flags == 1)[0] + 1
    headers_per_window = np.asarray(meta.headers, dtype=str)
    contig_order = sorted(stats)

    headers = np.array(
        [h[0] for h in np.split(headers_per_window, split_indices) if len(h)]
    )
    lengths = np.array(
        [s[0] for s in np.split(np.asarray(meta.seqlen, np.int32),
                                split_indices) if len(s)]
    )
    a, t, g, c = (np.asarray(v, float) for v in (meta.a, meta.t, meta.g, meta.c))
    ns_w = (fsize - (a + t + g + c)) / fsize
    gcs_w = (g + c) / fsize
    ns = [x for x in np.split(ns_w, split_indices) if len(x)]
    gcs = [x for x in np.split(gcs_w, split_indices) if len(x)]

    pred_sum = np.stack([stats[gid]["pred_sum"] for gid in contig_order])
    pred_var = np.stack([stats[gid]["pred_var"] for gid in contig_order])
    consensus = np.argmax(pred_sum, axis=1)
    frag_pred = [stats[gid]["frag_pred"] for gid in contig_order]
    per_class_counts = [
        {i: int(stats[gid]["cls_counts"][i]) for i in range(num_classes)}
        for gid in contig_order
    ]
    entropy = np.array([stats[gid]["entropy"] for gid in contig_order],
                       np.float16)
    energy = np.array([stats[gid]["energy"] for gid in contig_order],
                      np.float16)
    ood = (
        np.array([stats[gid].get("reliability", np.float16(0.0))
                  for gid in contig_order], np.float16)
        if with_reliability else None
    )
    prophage_contam = (pred_sum[:, 1] < pred_var[:, 1]) & (consensus == 0)
    host_contam = (pred_sum[:, 1] < pred_var[:, 1]) & (consensus == 1)

    return _two_pass_order({
        "headers": headers,
        "length": lengths,
        "consensus": consensus,
        "per_class_counts": per_class_counts,
        "pred_sum": pred_sum,
        "pred_var": pred_var,
        "frag_pred": frag_pred,
        "ood": ood,
        "has_reliability": with_reliability,
        "entropy": entropy,
        "energy": energy,
        "host_contam": host_contam,
        "prophage_contam": prophage_contam,
        "repeats": term_repeats,
        "gc": gcs,
        "ns": ns,
    }, fsize)


#: per-contig fields permuted together when reordering a data dict
_PER_CONTIG_KEYS = (
    "headers", "length", "lengths", "consensus", "per_class_counts",
    "pred_sum", "pred_var", "frag_pred", "ood", "entropy", "energy",
    "host_contam", "prophage_contam", "gc", "ns", "gcs", "gc_skews",
    "predictions", "starts",
)


def _two_pass_order(data: dict, fsize: int) -> dict:
    """Reorder per-contig arrays to the reference's row order.

    The reference predict runs the full-window pass first and APPENDS the
    ``min_len <= len < fsize`` short-window pass after it (reference
    ``commands/predict.py:771-816``), so its TSV lists every full-size
    contig (input order) before any short contig (input order). Our
    single bucketed stream interleaves them in input order; permute the
    per-contig fields to match (stable within each group).
    """
    lengths = np.asarray(data.get("length", data.get("lengths")))
    order = np.argsort(lengths < fsize, kind="stable")
    if np.array_equal(order, np.arange(order.size)):
        return data
    for key in _PER_CONTIG_KEYS:
        v = data.get(key)
        if v is None:
            continue
        if isinstance(v, np.ndarray):
            data[key] = v[order]
        elif isinstance(v, list):
            data[key] = [v[i] for i in order]
    return data


def _frac_above(values, threshold: float = 0.5) -> float:
    arr = np.asarray(values, dtype=float)
    if arr.size == 0:
        return 0.0
    return float((arr > threshold).mean())


def generate_summary(data: dict, labels: list[str], indices: list[int],
                     refined_contig: pd.DataFrame | None = None) -> pd.DataFrame:
    """Per-contig summary table.

    Parity: reference ``collect.py:438-558`` — same columns (class scores,
    window counts, run-length ``window_summary``, terminal-repeat join,
    refined-call merge, ``___``->``,`` un-escaping).
    """
    import pandas as pd

    class_map = {int(k): v for k, v in zip(indices, labels)}
    if data.get("has_reliability", True):
        reliability_score = data["ood"]
    else:
        reliability_score = ["unavailable"] * len(data["headers"])

    columns: dict = {
        "contig_id": data["headers"],
        "length": data["length"],
        "prediction": [class_map[int(x)] for x in data["consensus"]],
        "entropy": data["entropy"],
        "energy": data["energy"],
        "reliability_score": reliability_score,
        "host_contam": data["host_contam"],
        "prophage_contam": data["prophage_contam"],
        "G+C": [np.mean(x) for x in data["gc"]],
        "N%": [np.mean(x) for x in data["ns"]],
    }

    if len(class_map) > 2:
        for i, label in class_map.items():
            columns[f"#_{label}_windows"] = [
                x[i] for x in data["per_class_counts"]
            ]
        for i, label in class_map.items():
            columns[f"{label}_score"] = [x[i] for x in data["pred_sum"]]
            columns[f"{label}_var"] = [x[i] for x in data["pred_var"]]
    else:
        for i, label in class_map.items():
            columns[f"#_{label}_windows"] = [
                x[i] for x in data["per_class_counts"]
            ]
        columns["score"] = data["pred_sum"]
        columns["var"] = data["pred_var"]

    columns["window_summary"] = [
        H.get_window_summary(x, class_map=class_map) for x in data["frag_pred"]
    ]

    df = pd.DataFrame(columns)
    repeats = data.get("repeats")
    if repeats is not None:
        df = pd.merge(
            left=df,
            right=repeats[["contig_id", "terminal_repeats", "repeat_length"]],
            on="contig_id", how="left",
        )
    else:
        df["terminal_repeats"] = np.nan
        df["repeat_length"] = np.nan

    if refined_contig is not None:
        df = pd.merge(
            left=df,
            right=refined_contig[[
                "contig_id", "contig_call", "contig_top_logit",
                "contig_margin", "n_windows_used", "n_merged_windows",
            ]],
            on="contig_id", how="left",
        )

    df["contig_id"] = df["contig_id"].str.replace("___", ",")
    return df


def write_output(data: dict, output_table_path, output_phage_table_path,
                 labels: list[str], indices: list[int],
                 reliability_cutoff: float = 0.5, phage_score: float = 1,
                 refined_contig: pd.DataFrame | None = None) -> int:
    """Write the full summary TSV + the phage-only TSV.

    Parity: reference ``collect.py:561-608`` — ``N% < 0.3`` filter,
    tab-separated, ``%.3f`` floats, phage table gated on score and
    reliability cutoffs.
    """
    df = generate_summary(data, labels, indices, refined_contig).query(
        "`N%` < 0.3"
    )
    df.to_csv(output_table_path, sep="\t", index=False, float_format="%.3f")

    lower = [label.lower() for label in labels]
    if "phage" in lower:
        viral_label = labels[lower.index("phage")]
    elif "virus" in lower:
        viral_label = labels[lower.index("virus")]
    else:
        # custom class sets without a viral class: no phage table
        # (querying a nonexistent <label>_score column would crash)
        return len(df)

    if data.get("has_reliability", True):
        reliability_clause = f" and (reliability_score > {reliability_cutoff})"
    else:
        reliability_clause = ""
    phage_df = df.query(
        f'(prediction == "{viral_label}") and '
        f"({viral_label}_score > {phage_score}){reliability_clause}"
    )
    if not phage_df.empty:
        phage_df.to_csv(
            output_phage_table_path, sep="\t", index=False, float_format="%.3f"
        )
    return len(df)


def write_fasta_from_results(input_fasta: str, output_tsv: str,
                             output_fasta: str, width: int = 70) -> None:
    """Extract contigs named in the phage TSV into a FASTA.

    Parity: reference ``collect.py:613-640``.
    """
    import pandas as pd

    from jaeger_tpu_torch.seqops.fasta import read_fasta

    phages = set(pd.read_table(str(output_tsv))["contig_id"].tolist())
    with open(str(output_fasta), "w") as fh:
        for header, seq in read_fasta(str(input_fasta)):
            if header in phages:
                fh.write(f">{header}\n")
                for i in range(0, len(seq), width):
                    fh.write(f"{seq[i : i + width]}\n")
