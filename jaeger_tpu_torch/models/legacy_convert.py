"""Counterpart of `jaeger_tpu/models/legacy_convert.py`: legacy weights into
the port.

Keras ``.h5`` weight files -> flax variable trees (``{"params",
"batch_stats"}``, numpy leaves) for the legacy models of
:mod:`jaeger_tpu_torch.models.legacy`, which load them with
``load_state(model, params_from_jax(variables))``
(:mod:`jaeger_tpu_torch.models.artifacts`):

* :func:`convert_wres_h5`: the production ``WRes_1024.h5`` (the
  ``default`` model) -> :class:`WResModel` variables, by layer name;
* :func:`convert_experimental_h5`: a v2 ``experimental_*`` ``.h5`` ->
  :class:`ExperimentalModel` variables, by the structural matcher of
  :mod:`jaeger_tpu_torch.models.modern_convert` on the port's own
  template tree;
* :func:`build_default_bundle`: the shipped ``default`` bundle
  (``jaeger_tpu_torch/data/models/default``) from the ``.h5`` and the
  scikit-learn OOD pickle, so that the card machine, which has neither
  ``h5py`` nor scikit-learn, runs ``default``.

``h5py`` and ``joblib`` are imported inside the functions that read those
files. The TF SavedModel route (``convert_wres_checkpoint``) needs the
port of ``models/tf_checkpoint.py`` and is refused.
"""

from __future__ import annotations

import shutil
import zipfile
from pathlib import Path

import numpy as np

#: the files of a default bundle, as :func:`build_default_bundle` writes
#: them and ``commands/predict_legacy.py`` reads them
PARAMS_FILE = "params.msgpack"
OOD_FILE = "ood_default.npz"
STATS_FILES = ("batch_means.npy", "batch_std.npy")


def convert_wres_h5(h5_path: str | Path, num_res_blocks: int = 5) -> dict:
    """Keras ``.h5`` weight file (the production ``WRes_1024.h5``) ->
    WResModel variables. The first conv is named ``conv1d`` in the h5."""
    import h5py

    t: dict[str, np.ndarray] = {}
    with h5py.File(h5_path, "r") as f:
        def walk(group, prefix=""):
            for key in group:
                item = group[key]
                if isinstance(item, h5py.Dataset):
                    name = f"{prefix}/{key}".lstrip("/")
                    t[name.removesuffix(":0")] = np.asarray(item)
                else:
                    walk(item, f"{prefix}/{key}")

        walk(f)
    # keys look like 'conv1d/conv1d/kernel'; index by trailing pair
    suffixed = {"/".join(k.split("/")[-2:]): v for k, v in t.items()}
    if "conv1d/kernel" in suffixed and "block1_0/kernel" not in suffixed:
        suffixed["block1_0/kernel"] = suffixed["conv1d/kernel"]
        suffixed["block1_0/bias"] = suffixed["conv1d/bias"]
    return _assemble_wres(suffixed, num_res_blocks)


def convert_wres_checkpoint(saved_model_dir: str | Path,
                            num_res_blocks: int = 5) -> dict:
    """A reference TF SavedModel directory -> WResModel variables: not
    ported yet (it needs ``models/tf_checkpoint.py``)."""
    raise NotImplementedError(
        f"{saved_model_dir}: TF SavedModel weights need "
        f"models/tf_checkpoint.py, which is not yet ported to "
        f"jaeger_tpu_torch (ROADMAP.md queue 1, item 13); use a Keras .h5 "
        f"(WRes_1024.h5)")


def _assemble_wres(t: dict[str, np.ndarray], num_res_blocks: int = 5) -> dict:

    def need(name: str) -> np.ndarray:
        if name not in t:
            raise KeyError(
                f"tensor {name!r} missing from checkpoint; found "
                f"{sorted(t)[:10]}..."
            )
        return np.asarray(t[name])

    params: dict = {
        "aa": {"embedding": need("aa/embeddings")},
        "tower": {
            "block1_0": {"kernel": need("block1_0/kernel"),
                         "bias": need("block1_0/bias")},
            "block1_1": {"kernel": need("block1_1/kernel"),
                         "bias": need("block1_1/bias")},
            "bn1_0": {"scale": need("bn_block1_1/gamma"),
                      "bias": need("bn_block1_1/beta")},
            "bn1_1": {"scale": need("bn_block1_2/gamma"),
                      "bias": need("bn_block1_2/beta")},
        },
        "augdense-1": {"kernel": need("augdense-1/kernel"),
                       "bias": need("augdense-1/bias")},
        "augdense-2": {"kernel": need("augdense-2/kernel"),
                       "bias": need("augdense-2/bias")},
        "outdense": {"kernel": need("outdense/kernel"),
                     "bias": need("outdense/bias")},
    }
    batch_stats: dict = {
        "tower": {
            "bn1_0": {"mean": need("bn_block1_1/moving_mean"),
                      "var": need("bn_block1_1/moving_variance")},
            "bn1_1": {"mean": need("bn_block1_2/moving_mean"),
                      "var": need("bn_block1_2/moving_variance")},
        },
    }
    for n in range(num_res_blocks):
        params["tower"][f"block2_{n}_a"] = {
            "kernel": need(f"block2_{n}1/kernel"),
            "bias": need(f"block2_{n}1/bias"),
        }
        params["tower"][f"block2_{n}_b"] = {
            "kernel": need(f"block2_{n}2/kernel"),
            "bias": need(f"block2_{n}2/bias"),
        }
        params["tower"][f"bn2_{n}_a"] = {
            "scale": need(f"bn_block2_{n}1/gamma"),
            "bias": need(f"bn_block2_{n}1/beta"),
        }
        params["tower"][f"bn2_{n}_b"] = {
            "scale": need(f"bn_block2_{n}2/gamma"),
            "bias": need(f"bn_block2_{n}2/beta"),
        }
        batch_stats["tower"][f"bn2_{n}_a"] = {
            "mean": need(f"bn_block2_{n}1/moving_mean"),
            "var": need(f"bn_block2_{n}1/moving_variance"),
        }
        batch_stats["tower"][f"bn2_{n}_b"] = {
            "mean": need(f"bn_block2_{n}2/moving_mean"),
            "var": need(f"bn_block2_{n}2/moving_variance"),
        }
    return {"params": params, "batch_stats": batch_stats}


def convert_experimental_h5(h5_path: str | Path,
                            num_res_blocks: int = 10,
                            num_classes: int | None = None) -> dict:
    """Keras weights for the legacy v2 ``experimental_*`` architecture ->
    :class:`jaeger_tpu_torch.models.legacy.ExperimentalModel` variables.

    The structural matcher (:func:`jaeger_tpu_torch.models.modern_convert.
    map_weights_to_tree`) fills the port's own template tree: shape
    signatures tell the tower's entry, skip and head layers apart, and the
    Keras creation ordinal orders the repeated ``(3, 256, 256)`` residual
    convs. ``num_classes`` defaults to the out-head width in the file.
    """
    from jaeger_tpu_torch.models.legacy import (ExperimentalModel,
                                                variables_from_state)
    from jaeger_tpu_torch.models.modern_convert import (
        map_weights_to_tree, read_keras_weight_groups)

    groups = read_keras_weight_groups(h5_path)
    if num_classes is None:
        num_classes = 4
        for _path, arrays in groups:
            if (len(arrays) == 2 and arrays[0].ndim == 2
                    and arrays[0].shape[0] == 32
                    and arrays[0].shape[1] != 32):
                num_classes = int(arrays[0].shape[1])
    template = variables_from_state(ExperimentalModel(
        num_classes=num_classes, num_res_blocks=num_res_blocks))
    return map_weights_to_tree(template, groups)


def ood_from_pickle(pkl_path: str | Path):
    """The default model's scikit-learn OOD classifier (a binary,
    sigmoid-calibrated ``CalibratedClassifierCV`` over one
    ``LogisticRegression``) as a
    :class:`jaeger_tpu_torch.postprocess.legacy_collect.CalibratedLogistic`
    with the same ``predict_proba``."""
    import warnings

    import joblib

    from jaeger_tpu_torch.postprocess.legacy_collect import CalibratedLogistic

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf = joblib.load(pkl_path)
    (cal,) = clf.calibrated_classifiers_
    (calibrator,) = cal.calibrators
    est = cal.estimator
    if cal.method != "sigmoid" or len(clf.classes_) != 2:
        raise ValueError(f"{pkl_path}: expected a binary sigmoid-calibrated "
                         f"classifier, got method {cal.method!r} with "
                         f"{len(clf.classes_)} classes")
    return CalibratedLogistic(est.coef_, est.intercept_, calibrator.a_,
                              calibrator.b_, clf.classes_)


def write_npz(path: str | Path, **arrays) -> None:
    """``np.savez`` with a fixed timestamp on every member, so the same
    arrays always give the same bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name, value in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", (1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asanyarray(value),
                                          allow_pickle=False)


def build_default_bundle(h5_path: str | Path, pkl_path: str | Path,
                         out_dir: str | Path) -> Path:
    """Write the port's ``default`` bundle into ``out_dir``: the WRes
    variables as a flax msgpack (``params.msgpack``, ``{"params",
    "batch_stats"}``), the OOD classifier (``ood_default.npz``: ``coef``,
    ``intercept``, ``a``, ``b``, ``classes``) and copies of
    ``batch_means.npy`` / ``batch_std.npy`` from beside the ``.h5``."""
    from jaeger_tpu_torch.models.artifacts import write_flax_msgpack

    h5_path, out_dir = Path(h5_path), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    variables = convert_wres_h5(h5_path)
    tree = {coll: _f32_tree(variables[coll])
            for coll in ("params", "batch_stats")}
    write_flax_msgpack(tree, out_dir / PARAMS_FILE)
    ood = ood_from_pickle(pkl_path)
    write_npz(out_dir / OOD_FILE, coef=ood.coef, intercept=ood.intercept,
              a=np.float64(ood.a), b=np.float64(ood.b), classes=ood.classes_)
    for name in STATS_FILES:
        shutil.copyfile(h5_path.parent / name, out_dir / name)
    return out_dir


def _f32_tree(tree: dict) -> dict:
    return {k: (_f32_tree(v) if isinstance(v, dict)
                else np.ascontiguousarray(v, dtype=np.float32))
            for k, v in tree.items()}
