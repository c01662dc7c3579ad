"""Copy of `jaeger_tpu/postprocess/cpd.py`.

Change-point detection + knee location.

Replaces the reference's ``ruptures.KernelCPD(kernel="linear", min_size=3,
jump=1)`` and ``kneed.KneeLocator`` dependencies
(``postprocess/prophages.py:554-572``) with in-repo implementations:

* :func:`kernel_cpd_linear` — exact penalized segmentation under the
  linear-kernel cost ``V(s,e) = sum ||x_t||^2 - ||sum x_t||^2/(e-s)``
  via PELT dynamic programming with pruning;
* :class:`KneeLocator` — the Kneedle algorithm (Satopaa et al. 2011)
  scoped to the convex/decreasing case the reference uses.
"""

from __future__ import annotations

import numpy as np


def kernel_cpd_linear(signal: np.ndarray, pen: float,
                      min_size: int = 3) -> list[int]:
    """Penalized change-point segmentation, linear kernel, exact (PELT).

    Returns breakpoint end-indices like ruptures: the last element is
    ``len(signal)``.
    """
    x = np.asarray(signal, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if n < 2 * min_size:
        return [n]

    # prefix sums for O(1) segment cost
    csum = np.concatenate([np.zeros((1, x.shape[1])), np.cumsum(x, axis=0)])
    csq = np.concatenate([[0.0], np.cumsum(np.sum(x * x, axis=1))])

    def cost(s: int, e: int) -> float:
        seg = csum[e] - csum[s]
        return csq[e] - csq[s] - float(seg @ seg) / (e - s)

    # PELT with min_size-aware DELAYED pruning. The textbook prune
    # ("drop s once F[s] + cost(s,t) > F[t]") is only safe for future
    # times t' >= t + min_size — before that, t itself is not a feasible
    # last changepoint, so a pruned s could still be the true optimum at
    # t' (caught by the exhaustive/forward-DP oracles,
    # tests/test_cpd_oracles.py). A dominated s is therefore only marked
    # at t and actually removed once t' - t >= min_size.
    F = np.full(n + 1, np.inf)
    F[0] = -pen
    prev = np.zeros(n + 1, dtype=np.int64)
    candidates = [0]
    pruned_at: dict[int, int] = {}
    for t in range(min_size, n + 1):
        best, best_s = np.inf, 0
        for s in candidates:
            if t - s < min_size:
                continue
            v = F[s] + cost(s, t) + pen
            if v < best:
                best, best_s = v, s
        F[t] = best
        prev[t] = best_s
        for s in candidates:
            if (t - s >= min_size and s not in pruned_at
                    and F[s] + cost(s, t) > F[t]):
                pruned_at[s] = t
        nxt = t - min_size + 1
        if 0 < nxt <= t and nxt not in candidates:
            candidates.append(nxt)
        candidates = sorted(
            s for s in set(candidates)
            if s not in pruned_at or t - pruned_at[s] < min_size
        )

    bkps = []
    t = n
    while t > 0:
        bkps.append(t)
        t = prev[t]
    return sorted(bkps)


class KneeLocator:
    """Kneedle knee finder for convex, decreasing discrete curves.

    Parity scope: the single call pattern in the reference
    (``KneeLocator(bkpt_lens, range(len), curve="convex",
    direction="decreasing")``) — attribute ``knee`` is the x value at the
    detected knee, or None.
    """

    def __init__(self, x, y, curve: str = "convex",
                 direction: str = "decreasing", S: float = 1.0):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.knee = None
        if len(x) < 3:
            return
        order = np.argsort(x)
        xs, ys = x[order], y[order]
        if xs[-1] == xs[0] or np.max(ys) == np.min(ys):
            return
        xn = (xs - xs[0]) / (xs[-1] - xs[0])
        yn = (ys - np.min(ys)) / (np.max(ys) - np.min(ys))
        if curve == "convex" and direction == "decreasing":
            yt = 1.0 - yn          # -> concave increasing
            xt = xn
        elif curve == "concave" and direction == "increasing":
            yt, xt = yn, xn
        elif curve == "concave" and direction == "decreasing":
            xt, yt = 1.0 - xn[::-1], yn[::-1]
        else:  # convex increasing
            xt, yt = xn, 1.0 - yn[::-1]
        diff = yt - xt
        # local maxima of the difference curve
        maxima = [
            i for i in range(1, len(diff) - 1)
            if diff[i] >= diff[i - 1] and diff[i] >= diff[i + 1]
        ]
        if not maxima and len(diff) > 1:
            maxima = [int(np.argmax(diff))]
        if not maxima:
            return
        # Kneedle threshold test with sensitivity S
        step = S * np.mean(np.diff(xn))
        for i in maxima:
            threshold = diff[i] - step
            rest = diff[i + 1:]
            if len(rest) == 0 or np.any(rest < threshold):
                self.knee = xs[i]
                return
        self.knee = xs[maxima[0]]
