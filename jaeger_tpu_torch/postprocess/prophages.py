"""Copy of `jaeger_tpu/postprocess/prophages.py`.

Prophage region segmentation, boundary report and plots.

Parity targets: reference ``postprocess/prophages.py`` —
``logits_to_df_v2`` (:99-153), ``segment`` (:524-602) with linear-kernel
change-point detection + penalty sweep + knee location,
``prophage_report`` (:605-874) with att-site Smith-Waterman around refined
boundaries, and the circular/linear score plots (:156-521, matplotlib
here; the circular plot uses a polar projection instead of pycirclize).
"""

from __future__ import annotations

import logging
from pathlib import Path

from typing import TYPE_CHECKING

import numpy as np

from jaeger_tpu_torch.postprocess.cpd import KneeLocator, kernel_cpd_linear
from jaeger_tpu_torch.postprocess.helpers import (
    merge_overlapping_ranges,
    scale_range,
)
from jaeger_tpu_torch.postprocess.sw import smith_waterman
from jaeger_tpu_torch.postprocess.termini import reverse_complement
from jaeger_tpu_torch.seqops.fasta import read_fasta

if TYPE_CHECKING:
    import pandas as pd

logger = logging.getLogger("jaeger_tpu_torch")


def logits_to_df_v2(class_map: dict, cmdline_kwargs: dict, headers,
                    predictions, lengths, gc_skews, gcs) -> dict:
    """Per-contig softmax score tracks (4-window smoothing, GC/GC-skew).

    Returns {contig_id: [DataFrame, host_label, length]} for contigs with
    length >= ``lc``.
    """
    import pandas as pd

    indices = class_map.get("index", [])
    classes = class_map.get("class", [])
    lab = {int(i): c for i, c in zip(indices, classes)}

    out = {}
    for key, value, length, gc_skew, gc in zip(
        headers, predictions, lengths, gc_skews, gcs
    ):
        if length < cmdline_kwargs.get("lc", 500_000):
            continue
        value = np.exp(value) / np.sum(np.exp(value), axis=1).reshape(-1, 1)
        max_class = int(np.argmax(np.mean(value, axis=0)))
        host = lab.get(max_class, "unknown")
        t = pd.DataFrame(value, columns=list(lab.values()))
        stride = cmdline_kwargs.get("stride") or cmdline_kwargs.get(
            "fsize", 2000
        )
        t = t.assign(
            length=[min(i * stride, int(length)) for i in range(len(t))]
        )
        for k, v in lab.items():
            conv = np.convolve(value[:, k], np.ones(4), mode="same")
            conv = _fit_len(conv, len(t))
            t[v] = conv
        t["gc"] = gc[: len(t)] if len(gc) > len(t) else gc
        skew = np.convolve(np.asarray(gc_skew), np.ones(10) / 10, mode="same")
        t["gc_skew"] = scale_range(_fit_len(skew, len(t)), -1, 1)
        out[f"{key}"] = [t, host, int(length)]
    return out


def _fit_len(arr: np.ndarray, n: int) -> np.ndarray:
    if len(arr) > n:
        return arr[:n]
    if len(arr) < n:
        return np.pad(arr, (0, n - len(arr)), mode="edge")
    return arr


def segment(logits_df: dict, outdir: Path | None = None,
            cutoff_length: int = 500_000, sensitivity: float = 1.5,
            identifier: str = "phage") -> dict:
    """Change-point segmentation of the smoothed viral-score track.

    Penalty sweep 1..9 -> knee of the (#breakpoints vs penalty) curve ->
    regions kept when their mean score exceeds ``sensitivity`` ->
    overlapping regions merged. Parity: reference ``prophages.py:524-602``.
    """
    phage_cordinates: dict = {}
    for key, (tmp, host, length) in logits_df.items():
        if length <= cutoff_length:
            continue
        try:
            signal = tmp[identifier].to_numpy()
            bkpts = [
                b for b in (
                    kernel_cpd_linear(signal, pen=i, min_size=3)
                    for i in range(1, 10)
                )
                if len(b) > 1
            ]
            if bkpts:
                bkpt_lens = np.array([len(b) for b in bkpts])
                kn = KneeLocator(
                    bkpt_lens, list(range(len(bkpts))),
                    curve="convex", direction="decreasing",
                )
                if kn.knee is not None:
                    bkpt_index = [len(b) for b in bkpts].index(kn.knee)
                else:
                    bkpt_index = int(np.searchsorted(bkpt_lens, 1))
                    if bkpt_index == len(bkpt_lens):
                        bkpt_index = None
                if bkpt_index is None:
                    phage_cordinates[key] = [[], []]
                    continue
                chosen = bkpts[bkpt_index]
                ranges = [chosen[i : i + 2] for i in range(len(chosen) - 1)]
                range_scores = np.array(
                    [tmp.loc[s:e][identifier].mean() for s, e in ranges]
                )
                range_mask = range_scores > sensitivity
                selected = merge_overlapping_ranges(
                    np.array(ranges)[range_mask]
                )
                phage_cordinates[key] = [
                    np.array(selected), range_scores[range_mask]
                ]
            else:
                phage_cordinates[key] = [[], []]
        except Exception:
            logger.debug("segmentation failed", exc_info=True)
            phage_cordinates[key] = [[], []]
    return phage_cordinates


def _att_summary(result, seq_len, header, sequence, cordinates, phage_score,
                 type_):
    """Parity: reference ``prophages.py:605-705``."""
    if result is None:
        s_start = cordinates["start"][0]
        e_end = cordinates["end"][0]
        region = sequence[s_start:e_end]
        gc_ = (
            (region.count("G") + region.count("C")) / len(region)
            if region else 0.0
        )
        return {
            "contig_id": header, "seq_len": seq_len,
            "region_len": e_end - s_start, "phage_score": phage_score,
            "n%": None, "gc%": gc_, "reject": None,
            "sstart": s_start, "send": None, "estart": None, "eend": e_end,
            "att_alignment_length": None, "att_identities": None,
            "att_identity": None, "att_score": None, "att_type": None,
            "att_fgaps": None, "att_rgaps": None, "attL": None, "attR": None,
        }

    alig_len = result.length
    f_gaps = result.query_aligned.count("-")
    rc_gaps = result.ref_aligned.count("-")
    iden = result.comp.count("|")
    ltr_cutoff = 250

    if type_ == "ITR":
        s_end = cordinates["start"][0] + result.end_query + 1
        s_start = s_end - alig_len
        e_start = cordinates["end"][1] - result.end_ref - 1
        e_end = e_start + alig_len
    else:  # DTR
        s_end = cordinates["start"][0] + result.end_query
        s_start = s_end - alig_len + 1
        e_end = cordinates["end"][0] + result.end_ref
        e_start = e_end - alig_len + 1
        if (s_end - s_start) >= ltr_cutoff:
            type_ = f"LTR_{type_}"

    region = sequence[s_start:e_end]
    n_pct = region.count("N") / len(region) if region else 0.0
    gc_ = (
        (region.count("G") + region.count("C")) / len(region)
        if region else 0.0
    )
    return {
        "contig_id": header, "seq_len": seq_len,
        "region_len": e_end - s_start, "phage_score": phage_score,
        "n%": n_pct, "gc%": gc_, "reject": n_pct > 0.20,
        "sstart": s_start, "send": s_end, "estart": e_start, "eend": e_end,
        "att_alignment_length": alig_len, "att_identities": iden,
        "att_identity": round(iden / alig_len, 2) if alig_len else None,
        "att_score": result.score, "att_type": type_,
        "att_fgaps": f_gaps, "att_rgaps": rc_gaps,
        "attL": result.query_aligned, "attR": result.ref_aligned,
    }


def prophage_report(fsize: int, filehandle, prophage_cordinates: dict,
                    outdir: Path, refined_boundaries: dict | None = None,
                    stride: int | None = None,
                    cutoff_length: int = 500_000) -> pd.DataFrame | None:
    """att-repeat search around each prophage region -> TSV.

    Parity: reference ``prophages.py:707-874``.
    """
    import pandas as pd

    step = stride or fsize
    summaries = []
    for raw_header, sequence in read_fasta(str(filehandle)):
        seq_len = len(sequence)
        header = raw_header.replace(",", "___")
        if seq_len <= cutoff_length:
            continue
        cords, scores = prophage_cordinates.get(header, [[], []])
        contig_refined = (
            refined_boundaries.get(header) if refined_boundaries else None
        )
        if len(cords) == 0 or len(scores) == 0:
            continue
        for idx, ((start, end), j) in enumerate(zip(cords, scores)):
            raw_start = int(start * step)
            raw_end = int((end - 1) * step + fsize)
            if contig_refined is not None and idx < len(contig_refined):
                _, _, refined_start, refined_end = contig_refined[idx]
            else:
                refined_start, refined_end = raw_start, raw_end

            region_len = refined_end - refined_start
            scan_length = min(max(int(seq_len * 0.04), 400), 4000)
            off_set = 2000 if region_len // 2 >= 14000 else region_len // 4

            search_start = max(refined_start - scan_length, 0)
            search_end = min(refined_end + scan_length, seq_len)
            left_seq = sequence[search_start : refined_start + off_set]
            right_seq = sequence[refined_end - off_set : search_end]

            if not left_seq or not right_seq:
                summary = _att_summary(
                    None, seq_len, header, sequence,
                    {"start": [refined_start, None],
                     "end": [refined_end, None]}, j, None,
                )
            else:
                result_dtr = smith_waterman(left_seq, right_seq)
                result_itr = smith_waterman(
                    left_seq, reverse_complement(right_seq)
                )
                cords_arg = {
                    "start": [search_start, search_start + off_set],
                    "end": [refined_end - off_set, search_end],
                }
                if result_itr.length > 12 or result_dtr.length > 12:
                    if result_itr.score > result_dtr.score:
                        summary = _att_summary(
                            result_itr, seq_len, header, sequence,
                            cords_arg, j, "ITR",
                        )
                    else:
                        summary = _att_summary(
                            result_dtr, seq_len, header, sequence,
                            cords_arg, j, "DTR",
                        )
                else:
                    summary = _att_summary(
                        None, seq_len, header, sequence,
                        {"start": [refined_start, None],
                         "end": [refined_end, None]}, j, None,
                    )
            summary["raw_start"] = raw_start
            summary["raw_end"] = raw_end
            summaries.append(summary)

    if summaries:
        df = pd.DataFrame(summaries)
        df["contig_id"] = df["contig_id"].str.replace("___", ",")
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        df.to_csv(outdir / "prophages_jaeger.tsv", sep="\t", index=False,
                  float_format="%.3f")
        logger.info(
            f"prophage coordinates saved at {outdir / 'prophages_jaeger.tsv'}"
        )
        return df
    return None


# ---------------------------------------------------------------------------
# Plots
# ---------------------------------------------------------------------------


def plot_scores_linear(logits_df: dict, fsize: int, infile_base: str,
                       outdir: Path, phage_cordinates: dict | None = None,
                       stride: int | None = None) -> list[Path]:
    """4-panel linear plot per contig: class scores, prophage highlights,
    GC, GC skew. Parity role: reference ``prophages.py:361-521``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    step = stride or fsize
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    score_cols_excl = {"length", "gc", "gc_skew"}
    for key, (t, host, length) in logits_df.items():
        fig, axes = plt.subplots(
            4, 1, figsize=(12, 8), sharex=True,
            gridspec_kw={"height_ratios": [3, 1, 1, 1]},
        )
        x = t["length"].to_numpy()
        for col in t.columns:
            if col in score_cols_excl:
                continue
            axes[0].plot(x, t[col].to_numpy(), label=col, linewidth=0.8)
        axes[0].set_ylabel("smoothed score")
        axes[0].legend(fontsize=7, ncol=3)
        axes[0].set_title(f"{key} (host: {host}, {length:,} bp)")

        if phage_cordinates:
            cords, scores = phage_cordinates.get(key, [[], []])
            for (s, e), sc in zip(cords, scores):
                for ax in axes[:2]:
                    ax.axvspan(s * step, (e - 1) * step + fsize,
                               color="crimson", alpha=0.25)
        axes[1].set_ylabel("prophage")
        axes[2].plot(x, t["gc"].to_numpy(), color="teal", linewidth=0.8)
        axes[2].set_ylabel("G+C")
        axes[3].plot(x, t["gc_skew"].to_numpy(), color="purple",
                     linewidth=0.8)
        axes[3].set_ylabel("GC skew")
        axes[3].set_xlabel("position (bp)")
        fig.tight_layout()
        path = outdir / f"{infile_base}_{_safe(key)}_linear.png"
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written


def plot_scores(logits_df: dict, fsize: int, infile_base: str, outdir: Path,
                phage_cordinates: dict | None = None,
                stride: int | None = None) -> list[Path]:
    """Circos-style per-contig plot, matching the reference's pycirclize
    figure track-for-track (``prophages.py:156-358``; pycirclize is
    matplotlib-polar underneath, so the same radial layout renders
    directly): outer tick ring (98-100), orange phage-score track
    (88-97) with magenta prophage highlights, per-class score track
    (78-87), mean-centered G+C (55-70, blue above / black below), GC
    skew (45-55, olive positive / purple negative), centered legend,
    PDF output named like the reference."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D
    from matplotlib.patches import Patch

    step = stride or fsize
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    aux_colors = ["gray", "green", "red", "teal", "brown", "purple",
                  "cyan", "pink"]
    score_cols_excl = {"length", "gc", "gc_skew"}

    for key, (t, host, length) in logits_df.items():
        theta = t["length"].to_numpy() / max(length, 1) * 2 * np.pi
        fig = plt.figure(figsize=(9, 9))
        ax = fig.add_subplot(projection="polar")
        ax.set_theta_zero_location("N")
        ax.set_theta_direction(-1)
        ax.set_ylim(0, 103)
        ax.set_yticks([])
        ax.spines["polar"].set_visible(False)
        ax.grid(False)

        # outer axis ring (reference track 98-100) + Mb-interval ticks
        ring = np.linspace(0, 2 * np.pi, 512)
        ax.fill_between(ring, 98, 100, color="lightgrey", zorder=1)
        major = 500_000 if length > 1_000_000 else max(
            10_000, int(length / 8) // 10_000 * 10_000 or 10_000)
        for pos in range(0, length + 1, major):
            a = pos / max(length, 1) * 2 * np.pi
            ax.plot([a, a], [100, 102], color="grey", lw=0.8)
            ax.text(a, 106, f"{pos / 1e6:.1f} Mb", ha="center",
                    va="center", fontsize=9)

        patches = []
        # phage score track (88-97), orange fill 0..4
        if "phage" in t.columns:
            sc = np.clip(t["phage"].to_numpy(), 0, 4) / 4.0
            ax.fill_between(theta, 88, 88 + sc * 9, color="orange",
                            alpha=1.0, zorder=2)
            if phage_cordinates:
                cords, _scores = phage_cordinates.get(key, [[], []])
                for s_, e_ in cords:
                    a0 = min(s_ * step, length) / max(length, 1) * 2 * np.pi
                    a1 = min((e_ - 1) * step + fsize, length) / max(
                        length, 1) * 2 * np.pi
                    span = np.linspace(a0, a1, 64)
                    ax.fill_between(span, 88, 97, color="magenta",
                                    alpha=0.3, lw=1, zorder=3)

        # other class scores (78-87)
        for j, col in enumerate(t.columns):
            if col in score_cols_excl or col == "phage":
                continue
            color = aux_colors[j % len(aux_colors)]
            sc = np.clip(t[col].to_numpy(), 0, 4) / 4.0
            ax.fill_between(theta, 78, 78 + sc * 9, color=color,
                            alpha=0.7, zorder=2)
            patches.append(Patch(color=color, label=col))

        # G+C, mean-centered (55-70): above-mean blue, below-mean black
        gc = t["gc"].to_numpy().astype(float)
        gc = gc - gc.mean()
        amax = max(float(np.max(np.abs(gc))), 1e-9)
        mid_gc = 62.5
        ax.fill_between(theta, mid_gc,
                        mid_gc + np.where(gc > 0, gc, 0) / amax * 7.5,
                        color="blue", alpha=0.5, zorder=2)
        ax.fill_between(theta, mid_gc,
                        mid_gc + np.where(gc < 0, gc, 0) / amax * 7.5,
                        color="black", zorder=2)

        # GC skew (45-55): positive olive, negative purple
        skew = t["gc_skew"].to_numpy().astype(float)
        smax = max(float(np.max(np.abs(skew))), 1e-9)
        mid_sk = 50.0
        ax.fill_between(theta, mid_sk,
                        mid_sk + np.where(skew > 0, skew, 0) / smax * 5,
                        color="olive", zorder=2)
        ax.fill_between(theta, mid_sk,
                        mid_sk + np.where(skew < 0, skew, 0) / smax * 5,
                        color="purple", zorder=2)

        handles = (
            [Patch(color="orange", label="phage"),
             Patch(color="magenta", alpha=0.3, label="putative prophage")]
            + patches
            + [Line2D([], [], color="blue",
                      label=r"$ > \overline{G+C}$", marker="^", ms=6,
                      ls="None", alpha=0.5),
               Line2D([], [], color="black",
                      label=r"$ < \overline{G+C}$", marker="v", ms=6,
                      ls="None"),
               Line2D([], [], color="olive", label="Positive GC Skew",
                      marker="^", ms=6, ls="None"),
               Line2D([], [], color="purple", label="Negative GC Skew",
                      marker="v", ms=6, ls="None")]
        )
        ax.legend(handles=handles, bbox_to_anchor=(0.51, 0.50),
                  loc="center", fontsize=10)
        plt.title(key.replace("___", ","),
                  fontdict={"size": 14, "weight": "bold"})
        path = outdir / f"{infile_base}_jaeger_{_safe(key.split(' ')[0])}.pdf"
        fig.savefig(path, bbox_inches="tight", dpi=300)
        plt.close(fig)
        written.append(path)
        logger.info(f"prophage plot saved at {path}")
    return written


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in name)[:80]
