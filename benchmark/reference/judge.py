"""The comparisons that decide ``correct``: the program's outputs against
the reference's, as numbers each held to a limit.

Beside the reference in float32 runs the same reference rounded as the
configuration states (``Reference(rounding="bfloat16")``): its gap to the
float32 reference is what rounding alone gives at this seed's weights. A
``*_ratio`` is the program's gap over that gap, so the weights' own
amplification of rounding, which moves every gap threefold from seed to
seed, cancels.

``predict`` (on what the timed path produced, for a sample of the contigs
served whole, drawn from the seed, the longest among them):

* ``windows``: over every contig whose last window was served, the
  windows the program counted against the windows its length gives, plus
  the windows of such contigs it lost; exact (limit 0).
* ``reduce``: sampled contigs whose reported window classes, float16 mean
  logits or float16 reliable share differ from those worked out again
  from the timed forward's own window logits (a mean may lie one float16
  step off, the sums' order being the device's); exact (limit 0).
* ``window_logit``, ``window_logit_mean``: the widest and the mean gap
  between a sampled window's class logits as the timed forward produced
  them and the reference's, in units of the spread (standard deviation)
  of the reference's class logits over the sample;
  ``window_logit_ratio``: the mean gap over the rounded reference's.
* ``reliability_mean``: the mean gap of the sampled windows' reliability
  logits, in units of the root mean square of the reference's;
  ``reliability_ratio``: that gap over the rounded reference's.

``train`` (on the steps the set-up drove through the window's own call):

* ``loss``: the widest relative gap of a step's loss.
* ``grad``: over the parameter leaves, the widest gap between the norms of
  the first clipped gradient, over the larger of the reference leaf's norm
  and the median leaf's.
* ``change``: the same for each leaf's change over the steps, on the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (AdamW moves the others by round-off alone).
* ``grad_median``, ``change_median``: the median over those leaves of each
  leaf's gap of norms over its own reference norm; ``grad_ratio``,
  ``change_ratio``: each over the rounded reference's.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.reduce import contig_reduce


def judge_predict(results: dict, expected: dict, ref_windows: dict,
                  prog_windows: dict, rounded_windows: dict) -> dict:
    """``results``: the program's per-contig entries keyed by contig id;
    ``expected``: the window count of each contig that was served whole;
    ``ref_windows`` / ``prog_windows`` / ``rounded_windows``: for each
    sampled contig, its windows' class logits and reliability logits
    ``(z, r)`` in window order: the reference's, the timed forward's
    (``None`` where the timed path produced none) and the rounded
    reference's. Returns the numbers by name."""
    lost = 0
    for g, n in expected.items():
        got = results.get(g)
        lost += n if got is None else abs(int(got["n_windows"]) - n)
    has_rel = all(r is not None for _, r in ref_windows.values())
    scale = max(float(np.concatenate([z for z, _ in ref_windows.values()]).std()),
                1e-12)
    rel_scale = (max(float(np.sqrt(np.mean(np.concatenate(
        [r for _, r in ref_windows.values()]) ** 2))), 1e-12) if has_rel else 1.0)
    gaps = {"z": [], "z_rounded": [], "r": [], "r_rounded": []}
    reduce = 0
    for g, (z_r, r_r) in ref_windows.items():
        got, prog = results.get(g), prog_windows.get(g)
        if got is None or prog is None or prog[0].shape != z_r.shape:
            reduce += 1
            continue
        z_p, r_p = prog
        z_b, r_b = rounded_windows[g]
        gaps["z"].append(np.abs(z_p - z_r).reshape(-1) / scale)
        gaps["z_rounded"].append(np.abs(z_b - z_r).reshape(-1) / scale)
        if has_rel:
            gaps["r"].append(np.abs(np.asarray(r_p, np.float64) - r_r).reshape(-1)
                             / rel_scale)
            gaps["r_rounded"].append(np.abs(np.asarray(r_b, np.float64) - r_r)
                                     .reshape(-1) / rel_scale)
        want = contig_reduce(z_p, r_p if has_rel else None)
        mean = want["mean"].astype(np.float64)
        off = (np.abs(got["pred_sum"].astype(np.float64) - mean)
               > np.spacing(want["mean"]).astype(np.float64))
        bad = (not np.array_equal(np.asarray(got["frag_pred"]), want["classes"])
               or bool(off.any())
               or (has_rel and np.float16(got["reliability"]) != want["reliability"]))
        reduce += int(bad)
    numbers = {"windows": float(lost), "reduce": float(reduce)}
    flat = {k: np.concatenate(v) for k, v in gaps.items() if v}
    if "z" in flat:
        numbers.update(window_logit=float(flat["z"].max()),
                       window_logit_mean=float(flat["z"].mean()),
                       window_logit_ratio=_ratio(flat["z"].mean(),
                                                 flat["z_rounded"].mean()))
    if "r" in flat:
        numbers.update(reliability_mean=float(flat["r"].mean()),
                       reliability_ratio=_ratio(flat["r"].mean(),
                                                flat["r_rounded"].mean()))
    return numbers


def _ratio(gap: float, rounded: float) -> float:
    return float(gap / max(rounded, 1e-30))


def _norm(t) -> float:
    return float(np.linalg.norm(np.asarray(t, np.float64).reshape(-1)))


def _leaf_gaps(prog: dict, ref: dict, initial: dict) -> tuple[dict, dict]:
    """The numbers of one run against the reference, and for the record
    each step's loss gap and the worst leaves."""
    loss_gaps = [abs(a - b) / max(abs(b), 1e-12)
                 for a, b in zip(prog["losses"], ref["losses"])]
    names = sorted(ref["first_grads"])
    g_ref = {k: _norm(ref["first_grads"][k]) for k in names}
    g_prog = {k: _norm(prog["first_grads"][k]) for k in names}
    g_med = float(np.median(list(g_ref.values())))
    moved = [k for k in names if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: _norm(np.asarray(ref["params"][k], np.float64)
                      - np.asarray(initial[k], np.float64)) for k in moved}
    d_prog = {k: _norm(np.asarray(prog["params"][k], np.float64)
                       - np.asarray(initial[k], np.float64)) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    grad = {k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med, 1e-30) for k in names}
    change = {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], d_med, 1e-30) for k in moved}
    numbers = {
        "loss": float(max(loss_gaps)), "grad": float(max(grad.values())),
        "change": float(max(change.values())),
        "grad_median": float(np.median(
            [abs(g_prog[k] - g_ref[k]) / max(g_ref[k], 1e-30) for k in moved])),
        "change_median": float(np.median(
            [abs(d_prog[k] - d_ref[k]) / max(d_ref[k], 1e-30) for k in moved]))}
    details = {"loss_gaps": loss_gaps, "grad_worst": max(grad, key=grad.get),
               "change_worst": max(change, key=change.get)}
    return numbers, details


def judge_train(prog: dict, ref: dict, rounded: dict,
                initial: dict) -> tuple[dict, dict]:
    """``prog`` / ``ref`` / ``rounded``: ``losses`` (per step),
    ``first_grads`` and ``params`` (after the steps), leaves keyed alike as
    host arrays: the program's, the reference's and the rounded
    reference's; ``initial``: the parameters all three started from.
    Returns the numbers by name and, for the record, each step's loss gap
    and the worst leaves."""
    numbers, details = _leaf_gaps(prog, ref, initial)
    base, _ = _leaf_gaps(rounded, ref, initial)
    for name in ("grad", "change"):
        numbers[f"{name}_ratio"] = _ratio(numbers[f"{name}_median"],
                                          base[f"{name}_median"])
    return numbers, details


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """(every number within its limit, [(name, number, limit)])."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
