"""Copy of `jaeger_tpu/utils/stats.py`.

Statistical tests over class logits and confidence scores.

Parity target: reference ``utils/stats.py`` — a one-tailed paired
t-test for "is the top-1 class significantly above the top-2" and a
summary-statistics Welch's t-test used by ``utils stats`` to annotate
every contig call with a p-value. Pinned live in
``tests/test_stats_live_parity.py``.
"""

from __future__ import annotations

from math import sqrt

import numpy as np


def significant_top_class(logits_class1, logits_class2,
                          alpha: float = 0.05) -> dict:
    """One-tailed paired t-test: top-1 logits significantly higher?

    Returns ``{"t_stat", "p_value", "significant"}`` (reference
    ``utils/stats.py:15-33``).
    """
    from scipy import stats as sps

    diffs = np.asarray(logits_class1, dtype=np.float64) - np.asarray(
        logits_class2, dtype=np.float64)
    t_stat, p_two = sps.ttest_1samp(diffs, 0)
    p_one = p_two / 2 if t_stat > 0 else 1 - (p_two / 2)
    return {"t_stat": t_stat, "p_value": p_one,
            "significant": bool(p_one < alpha)}


def welch_t_one_tailed(mean1, var1, n1, mean2, var2, n2,
                       alternative: str = "greater"):
    """One-tailed Welch's t-test from summary statistics.

    Returns ``(t_stat, df, p_value)`` with Welch–Satterthwaite degrees
    of freedom (reference ``utils/stats.py:36-66``).
    """
    from scipy import stats as sps

    se = sqrt(var1 / n1 + var2 / n2)
    t_stat = (mean1 - mean2) / se
    df_num = (var1 / n1 + var2 / n2) ** 2
    df_denom = ((var1 / n1) ** 2 / (n1 - 1)) + ((var2 / n2) ** 2 / (n2 - 1))
    df = df_num / df_denom
    if alternative == "greater":
        p = 1 - sps.t.cdf(t_stat, df)
    elif alternative == "less":
        p = sps.t.cdf(t_stat, df)
    else:
        raise ValueError(f"alternative must be greater/less: {alternative}")
    return t_stat, df, p
