"""Copy of `jaeger_tpu/postprocess/refinement.py`.

Post-hoc refinement of window- and contig-level predictions.

Parity target: reference ``postprocess/refinement.py:23-298`` (polars
there, pandas/numpy here): per-class logit+margin abstain thresholds fit
at a quantile of correct-diagonal validation windows, targeted merge
rules (bacteria_or_plasmid, virus_any), and gated/weighted/unweighted
contig aggregation with hedged calls; YAML persistence.
"""

from __future__ import annotations

from datetime import datetime, timezone
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

SCORE_COLS = [
    "phage_score", "virus_score", "archaea_score",
    "bacteria_score", "plasmid_score", "eukarya_score",
]
CLASSES = [c.replace("_score", "") for c in SCORE_COLS]

MERGE_MAP: dict[str, tuple[str, str]] = {
    "bacteria_or_plasmid": ("bacteria", "plasmid"),
    "virus_any": ("phage", "virus"),
}


def add_score_features(df: pd.DataFrame) -> pd.DataFrame:
    """Add top/second logit, margin, top_prob, entropy, class columns."""
    S = df[SCORE_COLS].to_numpy(dtype=np.float64)
    P = np.exp(S - S.max(axis=1, keepdims=True))
    P = P / P.sum(axis=1, keepdims=True)
    top2 = np.sort(S, axis=1)[:, -2:]
    top_idx = S.argmax(axis=1)
    second_idx = np.argsort(S, axis=1)[:, -2]
    out = df.copy()
    out["top_logit"] = top2[:, 1]
    out["second_logit"] = top2[:, 0]
    out["margin"] = top2[:, 1] - top2[:, 0]
    out["top_prob"] = P.max(axis=1)
    out["entropy"] = -(P * np.log(P + 1e-12)).sum(axis=1)
    out["top_class"] = [CLASSES[i] for i in top_idx]
    out["second_class"] = [CLASSES[i] for i in second_idx]
    return out


def fit_thresholds(val_df: pd.DataFrame,
                   quantile: float = 0.05) -> dict[str, dict[str, float]]:
    """Per-class thresholds from the correct-diagonal subset (pred==true)."""
    taus: dict[str, dict[str, float]] = {}
    for k in CLASSES:
        correct = val_df[
            (val_df["prediction"] == k) & (val_df["true"] == k)
        ]
        if len(correct) < 30:
            taus[k] = {"logit": -np.inf, "margin": -np.inf, "n": len(correct)}
            continue
        taus[k] = {
            "logit": float(np.quantile(correct["top_logit"], quantile)),
            "margin": float(np.quantile(correct["margin"], quantile)),
            "n": int(len(correct)),
        }
    return taus


def refine(df: pd.DataFrame, taus: dict[str, dict[str, float]],
           merge_bp: bool = True, merge_pv: bool = True) -> pd.DataFrame:
    """Merge rules first, then per-class abstain -> ``refined_prediction``.

    Each :data:`MERGE_MAP` rule fires on windows whose top two classes
    are exactly the rule's (unordered) pair AND whose margin falls under
    the fitted per-class margin threshold — a window torn between
    bacteria and plasmid becomes ``bacteria_or_plasmid`` rather than a
    coin flip. Windows no rule claimed abstain to ``unknown`` when
    either fitted threshold rejects them.
    """
    top_class = df["top_class"].to_numpy()
    second_class = df["second_class"].to_numpy()
    top_logit = df["top_logit"].to_numpy()
    margin = df["margin"].to_numpy()

    tau_logit = np.array([taus[c]["logit"] for c in top_class])
    tau_margin = np.array([taus[c]["margin"] for c in top_class])
    under_margin = margin < tau_margin
    refined = top_class.astype(object).copy()

    enabled = {"bacteria_or_plasmid": merge_bp, "virus_any": merge_pv}
    claimed = np.zeros(len(refined), dtype=bool)
    for label, pair in MERGE_MAP.items():
        if not enabled.get(label, True):
            continue
        top_in_pair = np.isin(top_class, pair)
        second_in_pair = np.isin(second_class, pair)
        hit = (top_in_pair & second_in_pair
               & (top_class != second_class)
               & under_margin & ~claimed)
        refined[hit] = label
        claimed |= hit

    abstain = ((top_logit < tau_logit) | under_margin) & ~claimed
    refined[abstain] = "unknown"
    out = df.copy()
    out["refined_prediction"] = refined
    return out


def aggregate_contig(
    window_df: pd.DataFrame,
    mode: str = "gated",
    min_windows: int = 3,
    merge_split: str = "half",
    allow_merged_contig_call: bool = False,
    contig_hedge_margin: float = 1.0,
) -> pd.DataFrame:
    """Aggregate refined windows into per-contig calls."""
    df = window_df.copy()
    if mode in ("gated", "weighted"):
        df = df[df["refined_prediction"] != "unknown"].copy()
    if mode == "weighted":
        df["_w"] = df["margin"].clip(lower=0.0)
    else:
        df["_w"] = 1.0

    merge_share = 0.5 if merge_split == "half" else 1.0
    refined = df["refined_prediction"].to_numpy()
    is_merged = np.isin(refined, list(MERGE_MAP.keys()))

    for score_col, class_name in zip(SCORE_COLS, CLASSES):
        labels_with_class = [
            lbl for lbl, members in MERGE_MAP.items() if class_name in members
        ]
        mult = np.where(
            is_merged,
            np.where(np.isin(refined, labels_with_class), merge_share, 0.0),
            1.0,
        )
        df[f"_agg_{score_col}"] = df[score_col] * df["_w"] * mult
    df["_merged"] = is_merged.astype(int)

    agg = df.groupby("contig_id").agg(
        **{c: (f"_agg_{c}", "sum") for c in SCORE_COLS},
        n_windows_used=("_w", "size"),
        total_weight=("_w", "sum"),
        n_merged_windows=("_merged", "sum"),
    ).reset_index()
    agg = agg[agg["n_windows_used"] >= min_windows].reset_index(drop=True)
    if agg.empty:
        return agg

    S = agg[SCORE_COLS].to_numpy()
    sorted_idx = np.argsort(S, axis=1)
    top_idx, second_idx = sorted_idx[:, -1], sorted_idx[:, -2]
    top_val = S[np.arange(len(S)), top_idx]
    second_val = S[np.arange(len(S)), second_idx]
    top_class = np.array([CLASSES[i] for i in top_idx])
    second_class = np.array([CLASSES[i] for i in second_idx])
    contig_margin = top_val - second_val

    if allow_merged_contig_call:
        merge_pairs = {
            frozenset(m): lbl for lbl, m in MERGE_MAP.items()
        }
        contig_call = np.array([
            merge_pairs.get(frozenset((t, s)), t)
            if m < contig_hedge_margin and frozenset((t, s)) in merge_pairs
            else t
            for t, s, m in zip(top_class, second_class, contig_margin)
        ])
    else:
        contig_call = top_class

    agg["contig_call"] = contig_call
    agg["contig_top_class"] = top_class
    agg["contig_second_class"] = second_class
    agg["contig_top_logit"] = top_val
    agg["contig_margin"] = contig_margin
    return agg


def save_refinement(taus: dict, path, *, jaeger_model: str, quantile: float,
                    merge_rules: tuple = ("bacteria_or_plasmid", "virus_any"),
                    val_cohort: str | None = None,
                    notes: str | None = None) -> None:
    import yaml

    payload: dict[str, Any] = {
        "schema_version": 1,
        "jaeger_model": jaeger_model,
        "created": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "quantile": quantile,
        "classes": CLASSES,
        "score_cols": SCORE_COLS,
        "merge_rules": list(merge_rules),
        "val_cohort": val_cohort,
        "notes": notes,
        "taus": {
            k: {"logit": float(v["logit"]), "margin": float(v["margin"]),
                "n": int(v["n"])}
            for k, v in taus.items()
        },
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(yaml.safe_dump(payload, sort_keys=False))


def load_refinement(path, expect_model: str | None = None) -> dict[str, Any]:
    import yaml

    meta = yaml.safe_load(Path(path).read_text())
    if meta.get("schema_version", 0) != 1:
        raise ValueError(
            f"unsupported refinement schema version {meta.get('schema_version')}"
        )
    if expect_model is not None and meta["jaeger_model"] != expect_model:
        raise ValueError(
            f"refinement calibrated for {meta['jaeger_model']}, current model "
            f"is {expect_model}"
        )
    return meta
