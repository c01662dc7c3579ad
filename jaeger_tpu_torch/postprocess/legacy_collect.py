"""Copy of `jaeger_tpu/postprocess/legacy_collect.py`.

Legacy (v1/v2 model family) window->contig reduction and TSV writer, on
the host:

* ``reduce_windows_legacy`` -- reference ``postprocess/collect.py:23-97``
* ``generate_summary_legacy`` / ``write_output_legacy``
                             -- reference ``postprocess/collect.py:100-229``
* ``ood_predict_default`` + normalizers
                             -- reference ``postprocess/helpers.py:476-566``
* ``get_window_summary_legacy`` -- reference ``postprocess/helpers.py:43-69``

The legacy schema differs from the modern one: per-contig statistics are
taken over RAW logits (the reference applies ``softmax_entropy`` -- a
clip-and-log2 entropy -- directly to the unnormalized outputs),
``reliability_score`` is the mean per-window OOD ID probability, and
the ``default`` model adds G+C / N% / ``prediction_2`` columns.

The ``"sklearn"`` OOD parameters take any object with a
``predict_proba``; the port ships the default model's classifier as
:class:`CalibratedLogistic` (an ``.npz``), so scikit-learn is not needed.
``pandas`` is imported inside the functions that need it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from jaeger_tpu_torch.postprocess.helpers import find_runs

#: the legacy model family's reference config entries
#: (``data/config.json`` in the reference; configuration data, not code)
LEGACY_CONFIGS = {
    "default": {
        "model": "default",
        "num_classes": 4,
        "all_labels": {0: "bacteria", 1: "phage", 2: "eukarya",
                       3: "archaea"},
        "default_labels": {0: "non-phage", 1: "phage", 2: "non-phage",
                           3: "non-phage"},
        "second": {1: "eukarya", 2: "archaea", 3: "bacteria", 0: ""},
        "suffix": "default",
        "vindex": 1,
    },
    "experimental_1": {
        "model": "experimental_1",
        "num_classes": 3,
        "all_labels": {0: "cellular", 1: "phage", 2: "plasmid"},
        "default_labels": {0: "cellular", 1: "phage", 2: "plasmid"},
        "second": None,
        "suffix": "experimental-1",
        "vindex": 1,
    },
    "experimental_2": {
        "model": "experimental_2",
        "num_classes": 5,
        "all_labels": {0: "bacteria", 1: "protozoa", 2: "archaea",
                       3: "fungi", 4: "phage"},
        "default_labels": {0: "cellular", 1: "cellular", 2: "cellular",
                           3: "cellular", 4: "phage"},
        "second": None,
        "suffix": "experimental-2",
        "vindex": 4,
    },
}

DEFAULT_CONFIG = LEGACY_CONFIGS["default"]


def softmax_entropy(p, axis=-1, eps=1e-12):
    """Reference ``helpers.py:175-177`` — clip-and-log2 'entropy' applied
    to whatever the model emitted (raw logits for the legacy models)."""
    p = np.clip(p, eps, 1.0)
    return -np.sum(p * np.log2(p), axis=axis)


def normalize_rows(x):
    """Per-row standardization (reference ``helpers.py:476-493``)."""
    x_mean = x.mean(axis=1).reshape(-1, 1)
    x_std = x.std(axis=1).reshape(-1, 1)
    return (x - x_mean) / x_std


class CalibratedLogistic:
    """A binary sigmoid-calibrated logistic regression with scikit-learn's
    ``CalibratedClassifierCV.predict_proba`` (one ``LogisticRegression``,
    one ``_SigmoidCalibration``), in float64:

        f = x @ coef.T + intercept      p1 = 1 / (1 + exp(a f + b))

    and ``[1 - p1, p1]``, with values in ``(1, 1 + 1e-5]`` set to 1 as
    scikit-learn sets them.
    """

    def __init__(self, coef, intercept, a, b, classes=(0.0, 1.0)):
        self.coef = np.asarray(coef, np.float64).reshape(1, -1)
        self.intercept = np.asarray(intercept, np.float64).reshape(1)
        self.a = float(a)
        self.b = float(b)
        self.classes_ = np.asarray(classes, np.float64)

    @classmethod
    def load(cls, path: str | Path) -> "CalibratedLogistic":
        """From an ``.npz`` with ``coef``, ``intercept``, ``a``, ``b`` and
        ``classes``."""
        with np.load(path) as z:
            return cls(z["coef"], z["intercept"], z["a"], z["b"],
                       z["classes"])

    def predict_proba(self, x) -> np.ndarray:
        f = (np.asarray(x) @ self.coef.T + self.intercept).reshape(-1)
        p1 = 1.0 / (1.0 + np.exp(self.a * f + self.b))
        proba = np.zeros((f.shape[0], 2))
        proba[:, 1] = p1
        proba[:, 0] = 1.0 - proba[:, 1]
        proba[(1.0 < proba) & (proba <= 1.0 + 1e-5)] = 1.0
        return proba


def ood_predict_default(x_features, params):
    """Per-window ID probabilities (reference ``helpers.py:530-566``)."""
    if params is None:
        return None, None
    if params["type"] == "params":
        x = normalize_rows(x_features)
        logits = np.dot(x, params["coeff"].reshape(-1, 1)) + params["intercept"]
        return (1 / (1 + np.exp(-logits))).flatten(), logits
    if params["type"] == "sklearn":
        x = (x_features - params["batch_mean"]) / params["batch_std"]
        x = x / np.linalg.norm(x, 2, axis=1).reshape(-1, 1)
        return params["model"].predict_proba(x)[:, 0], 0
    raise ValueError(f"unknown ood params type {params['type']!r}")


def get_window_summary_legacy(x, phage_pos: int) -> str:
    """Run-length ``12n3V`` string over phage/non-phage windows
    (reference ``helpers.py:43-69``)."""
    x = np.asarray(x).flatten()
    items, run_length, _ = find_runs(x == phage_pos)
    run_length = np.array(run_length, dtype=np.str_)
    tmp = np.empty(items.shape, dtype=np.str_)
    tmp[~items] = "n"
    tmp[items] = "V"
    return "".join(np.char.add(run_length, tmp))


def reduce_windows_legacy(config: dict, logits: np.ndarray,
                          embeddings: np.ndarray | None, meta, fsize: int,
                          ood_params: dict | None,
                          term_repeats) -> dict:
    """Group windows per contig and compute the legacy statistics
    (reference ``pred_to_dict_legacy``, ``collect.py:23-97``)."""
    num_classes = config["num_classes"]
    split_indices = np.where(
        np.asarray(meta.contig_end, np.int32) == 1)[0] + 1
    if logits.shape[0] == split_indices[-1]:
        split_indices = split_indices[:-1]
    predictions = np.split(logits, split_indices, axis=0)

    if embeddings is not None and ood_params is not None:
        ood = [
            ood_predict_default(e, ood_params)[0]
            for e in np.split(embeddings, split_indices, axis=0)
        ]
        has_reliability = True
    else:
        ood = None
        has_reliability = False

    headers = np.split(np.asarray(meta.headers, np.str_), split_indices)
    lengths = np.split(np.asarray(meta.seqlen, np.int32), split_indices)
    g = np.asarray(meta.g, float)
    c = np.asarray(meta.c, float)
    a = np.asarray(meta.a, float)
    t = np.asarray(meta.t, float)
    ns = np.split((fsize - (a + t + g + c)) / fsize, split_indices)
    gcs = np.split((g + c) / fsize, split_indices)

    lengths = np.array([x[0] for x in lengths])
    headers = np.array([x[0] for x in headers])

    pred_sum = np.array([np.mean(x, axis=0) for x in predictions],
                        np.float16)
    pred_var = np.array([np.var(x, axis=0) for x in predictions],
                        np.float16)
    consensus = np.argmax(pred_sum, axis=1)
    frag_pred = [np.argmax(x, axis=-1) for x in predictions]
    per_class_counts = [
        {i: 0 for i in range(num_classes)}
        | dict(zip(*np.unique(x, return_counts=True)))
        for x in frag_pred
    ]
    entropy_mean = np.array(
        [np.mean(softmax_entropy(x), axis=0) for x in predictions],
        np.float16,
    )
    prophage_contam = (pred_sum[:, 1] < pred_var[:, 1]) * (consensus == 0)
    host_contam = (pred_sum[:, 1] < pred_var[:, 1]) * (consensus == 1)

    return {
        "headers": headers,
        "length": lengths,
        "consensus": consensus,
        "per_class_counts": per_class_counts,
        "pred_sum": pred_sum,
        "pred_var": pred_var,
        "frag_pred": frag_pred,
        "ood": ood,
        "entropy": entropy_mean,
        "host_contam": host_contam,
        "prophage_contam": prophage_contam,
        "repeats": term_repeats,
        "gc": gcs,
        "ns": ns,
        "has_reliability": has_reliability,
    }


def generate_summary_legacy(config: dict, data: dict):
    """Reference ``generate_summary_legacy`` (``collect.py:100-185``): a
    pandas DataFrame."""
    import pandas as pd

    class_map = config["labels"]
    lab = {int(k): v for k, v in config["all_labels"].items()}

    if data.get("has_reliability", True):
        reliability_score = [np.mean(x) for x in data["ood"]]
    else:
        reliability_score = ["unavailable"] * len(data["headers"])

    columns = {
        "contig_id": data["headers"],
        "length": data["length"],
        "prediction": [class_map[x] for x in data["consensus"]],
        "entropy": data["entropy"],
        "reliability_score": reliability_score,
        "host_contam": data["host_contam"],
        "prophage_contam": data["prophage_contam"],
    }

    if config["model"] == "default":
        columns["G+C"] = [np.mean(x) for x in data["gc"]]
        columns["N%"] = [np.mean(x) for x in data["ns"]]
        # second-highest class: which (top-2) argsort pattern matched
        ev = np.prod(
            np.argsort(data["pred_sum"], axis=1)[:, 2:4] == np.array([2, 1]),
            axis=1)
        av = np.prod(
            np.argsort(data["pred_sum"], axis=1)[:, 2:4] == np.array([3, 1]),
            axis=1) * 2
        bv = np.prod(
            np.argsort(data["pred_sum"], axis=1)[:, 2:4] == np.array([0, 1]),
            axis=1) * 3
        class_map2 = {int(k): v for k, v in config["second"].items()}
        columns["prediction_2"] = [class_map2[x] for x in (ev + av + bv)]

    for i, label in lab.items():
        columns[f"#_{label}_windows"] = [
            x[i] for x in data["per_class_counts"]]
        columns[f"{label}_score"] = [x[i] for x in data["pred_sum"]]
        columns[f"{label}_var"] = [x[i] for x in data["pred_var"]]

    columns["window_summary"] = [
        get_window_summary_legacy(x, config["vindex"])
        for x in data["frag_pred"]
    ]

    df = pd.DataFrame(columns).set_index("contig_id")
    if data.get("repeats") is not None and len(data["repeats"]):
        df = df.join(
            data["repeats"].set_index("contig_id")[
                ["terminal_repeats", "repeat_length"]],
            how="left",
        ).reset_index(names="contig_id")
    else:
        df = df.reset_index(names="contig_id")
        df["terminal_repeats"] = np.nan
        df["repeat_length"] = np.nan
    df["contig_id"] = df["contig_id"].str.replace("___", ",")
    return df


def write_output_legacy(config: dict, data: dict, *, output_table_path,
                        output_phage_table_path,
                        reliability_cutoff: float = 0.5,
                        phage_score: float = 3) -> int:
    """Reference ``write_output_legacy`` (``collect.py:188-229``)."""
    df = generate_summary_legacy(config, data)
    df.to_csv(output_table_path, sep="\t", index=False, float_format="%.3f")
    reliability_clause = (
        f" and (reliability_score > {reliability_cutoff})"
        if data.get("has_reliability", True) else ""
    )
    df.query(
        f'(prediction == "phage") and (phage_score > {phage_score})'
        f"{reliability_clause}"
    ).to_csv(output_phage_table_path, sep="\t", index=False,
             float_format="%.3f")
    return len(df)
