"""Copy of `jaeger_tpu/postprocess/helpers.py`.

Numpy helpers for the window->contig reduction.

Parity targets: reference ``postprocess/helpers.py`` — run-length window
summaries, entropy/energy scores, and the linear-chain CRF (Viterbi) window
decoder with its biological transition prior.
"""

from __future__ import annotations

import numpy as np


def find_runs(x) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Runs of consecutive identical items: (values, lengths, starts)."""
    x = np.asanyarray(x)
    if x.ndim != 1:
        raise ValueError("only 1D arrays are supported")
    n = x.shape[0]
    if n == 0:
        return (np.array([], dtype=x.dtype), np.array([], int), np.array([], int))
    starts_mask = np.empty(n, dtype=bool)
    starts_mask[0] = True
    np.not_equal(x[:-1], x[1:], out=starts_mask[1:])
    starts = np.nonzero(starts_mask)[0]
    values = x[starts]
    lengths = np.diff(np.append(starts, n))
    return values, lengths, starts


def get_window_summary(x, class_map: dict[int, str],
                       classes: list[str] = ("virus", "phage")) -> str:
    """Run-length string like ``12n3V`` (viral classes uppercase).

    Parity: reference ``postprocess/helpers.py:73-108``.
    """
    def vmap(label: str) -> str:
        if label.lower() in classes:
            return label[0].upper()
        return label[0].lower()

    symbols = {k: vmap(v) for k, v in class_map.items()}
    x = np.asarray(x).flatten()
    values, lengths, _ = find_runs(x)
    return "".join(f"{int(n)}{symbols[int(v)]}" for v, n in zip(values, lengths))


def update_dict(unique_counts, num_classes: int = 4) -> dict[int, int]:
    """Per-class count dict with zero-filled missing classes."""
    base = {i: 0 for i in range(num_classes)}
    base.update({int(k): int(v) for k, v in zip(*unique_counts)})
    return base


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def softmax(x):
    x = np.asarray(x, dtype=np.float64)
    ex = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return ex / np.sum(ex, axis=-1, keepdims=True)


def binary_entropy(p, eps: float = 1e-12):
    p = np.clip(p, eps, 1 - eps)
    return -(p * np.log2(p) + (1 - p) * np.log2(1 - p))


def softmax_entropy(p, axis: int = -1, eps: float = 1e-12):
    p = np.clip(p, eps, 1.0)
    return -np.sum(p * np.log2(p), axis=axis)


def logsumexp(x: np.ndarray, axis: int = -1) -> np.ndarray:
    xmax = np.max(x, axis=axis, keepdims=True)
    return xmax.squeeze(axis=axis) + np.log(
        np.sum(np.exp(x - xmax), axis=axis)
    )


def energy(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Energy OOD score from logits (lower = more confident).

    Parity: reference ``postprocess/helpers.py:189-219`` including its
    binary/2-class special cases.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 0:
        return -logsumexp(np.array([x, 0.0]), axis=-1)
    if x.shape[-1] == 2:
        return -logsumexp(x, axis=axis)
    squeezed = x.squeeze(axis=-1) if x.shape[-1] == 1 else x
    return -logsumexp(
        np.stack([squeezed, np.zeros_like(squeezed)], axis=-1), axis=-1
    )


# --- linear-chain CRF window decoding (reference helpers.py:277-449) --------

_CRF_PRIOR_TIERS: tuple = (
    (0.5, (("bacteria", "phage"), ("bacteria", "plasmid"),
           ("archaea", "phage"), ("archaea", "plasmid"),
           ("phage", "plasmid"), ("eukarya", "virus"))),
    (3.0, (("bacteria", "eukarya"), ("archaea", "eukarya"),
           ("bacteria", "archaea"), ("eukarya", "phage"),
           ("eukarya", "plasmid"))),
)


def default_transition_prior(class_names: list[str]) -> np.ndarray:
    names = [str(n).lower() for n in class_names]
    n = len(names)
    prior = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(prior, 0.0)
    for value, pairs in _CRF_PRIOR_TIERS:
        for a, b in pairs:
            if a in names and b in names:
                i, j = names.index(a), names.index(b)
                prior[i, j] = prior[j, i] = value
    return prior


def build_transition_costs(class_names: list[str], switch_cost: float,
                           prior: str = "biological",
                           user_matrix: dict | None = None) -> np.ndarray:
    names = [str(n).lower() for n in class_names]
    n = len(names)
    if user_matrix:
        p = np.ones((n, n), dtype=np.float64)
        np.fill_diagonal(p, 0.0)
        for a, row in user_matrix.items():
            a = str(a).lower()
            if a not in names or not isinstance(row, dict):
                continue
            for b_, value in row.items():
                b_ = str(b_).lower()
                if b_ not in names:
                    continue
                i, j = names.index(a), names.index(b_)
                p[i, j] = p[j, i] = float(value)
        np.fill_diagonal(p, 0.0)
    elif prior == "uniform":
        p = np.ones((n, n), dtype=np.float64)
        np.fill_diagonal(p, 0.0)
    else:
        p = default_transition_prior(names)
    return float(switch_cost) * p


def viterbi_decode(logits: np.ndarray, switch_cost: float = 2.0,
                   transition_costs: np.ndarray | None = None) -> np.ndarray:
    """Exact MAP decode of a contig's window labels, O(T*C^2).

    Parity: reference ``postprocess/helpers.py:398-449``.
    """
    z = np.asarray(logits, dtype=np.float64)
    if z.ndim == 1:
        z = z.reshape(1, -1)
    t_len, n_classes = z.shape
    emissions = z - logsumexp(z, axis=-1)[:, None]
    if t_len == 1 or n_classes == 1:
        return np.argmax(emissions, axis=-1)
    if transition_costs is None:
        costs = np.full((n_classes, n_classes), float(switch_cost))
        np.fill_diagonal(costs, 0.0)
    else:
        costs = np.asarray(transition_costs, dtype=np.float64)
    delta = emissions[0]
    backptr = np.empty((t_len, n_classes), dtype=np.int64)
    for t in range(1, t_len):
        scores = delta[:, None] - costs
        backptr[t] = np.argmax(scores, axis=0)
        delta = emissions[t] + scores[backptr[t], np.arange(n_classes)]
    path = np.empty(t_len, dtype=np.int64)
    path[-1] = int(np.argmax(delta))
    for t in range(t_len - 2, -1, -1):
        path[t] = backptr[t + 1][path[t + 1]]
    return path


def merge_overlapping_ranges(intervals):
    """Merge overlapping [start, end] intervals."""
    if len(intervals) == 0:
        return []
    intervals = sorted(intervals, key=lambda x: x[0])
    merged = [list(intervals[0])]
    for start, end in intervals[1:]:
        if start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def safe_divide(a, b):
    return a / b if b else 0.0


def scale_range(values: np.ndarray, lo: float, hi: float) -> np.ndarray:
    values = np.asarray(values, dtype=np.float64)
    values = values - np.min(values)
    peak = np.max(values)
    if peak > 0:
        values = values / (peak / (hi - lo))
    return values + lo
