"""Counterpart of `jaeger_tpu/commands/predict_legacy.py`: the legacy
predict workflow (the ``default`` 4-class model and ``experimental_*``).

Load the legacy weights into the WRes (or v2 experimental) architecture
(:mod:`jaeger_tpu_torch.models.legacy`), run the windows through it in f32
on the device, compute the OOD score of the 128-wide embeddings (batch
statistics and L2 normalization, then the calibrated logistic
regression), and reduce to the legacy 4-class summary TSV
(:mod:`jaeger_tpu_torch.postprocess.legacy_collect`).

The ``default`` model is the port's shipped bundle
(``jaeger_tpu_torch/data/models/default``, written by
:func:`jaeger_tpu_torch.models.legacy_convert.build_default_bundle` from
the JAX package's ``WRes_1024.h5`` and OOD pickle): ``params.msgpack``,
``ood_default.npz`` and the batch statistics. A ``--model-dir`` may
instead hold the Keras ``WRes_1024.h5`` and ``LR_ood_4_class_default.pkl``
(read with ``h5py`` and ``joblib``, as JAX reads them). ``experimental*``
needs a Keras ``.h5`` in ``--model-dir``; without ``h5py`` its
``ImportError`` surfaces, as in JAX.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.postprocess import collect
from jaeger_tpu_torch.seqops.fasta import fasta_stem, validate_fasta_entries
from jaeger_tpu_torch.seqops.windows import window_batches
from jaeger_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("jaeger_tpu_torch")

LEGACY_LABELS = ["bacteria", "phage", "eukarya", "archaea"]
#: the port's shipped default bundle
DEFAULT_MODEL_DIR = (
    Path(__file__).resolve().parent.parent / "data" / "models" / "default"
)


def _load_ood(model_dir: Path):
    """(OOD classifier or None, batch_mean, batch_std): the shipped
    ``ood_default.npz``, else the scikit-learn pickle (dropped with a
    warning when it cannot be loaded, as in JAX)."""
    from jaeger_tpu_torch.models.legacy_convert import OOD_FILE, ood_from_pickle
    from jaeger_tpu_torch.postprocess.legacy_collect import CalibratedLogistic

    clf = None
    pkl = model_dir / "LR_ood_4_class_default.pkl"
    if (model_dir / OOD_FILE).exists():
        clf = CalibratedLogistic.load(model_dir / OOD_FILE)
    elif pkl.exists():
        try:
            clf = ood_from_pickle(pkl)
        except Exception as e:
            logger.warning(f"could not load OOD model: {e}")
    mean = std = None
    if (model_dir / "batch_means.npy").exists():
        mean = np.load(model_dir / "batch_means.npy")
        std = np.load(model_dir / "batch_std.npy")
    return clf, mean, std


def load_legacy_model(model_dir: Path, model_name: str = "default",
                      num_res_blocks: int = 10, device=None):
    """(model on ``device`` in eval mode, encoder) for ``model_name`` from
    ``model_dir``."""
    from jaeger_tpu_torch.models import legacy_convert as lcv
    from jaeger_tpu_torch.models.artifacts import (load_state,
                                                   params_from_jax,
                                                   read_flax_msgpack)
    from jaeger_tpu_torch.models.legacy import (ExperimentalModel, WResModel,
                                                encode_amino_windows,
                                                encode_murphy_windows)

    if model_name.startswith("experimental"):
        if model_dir == DEFAULT_MODEL_DIR:
            raise FileNotFoundError(
                "experimental models are not bundled; pass --model-dir "
                "pointing at the Keras .h5 weights")
        h5s = sorted(model_dir.glob("*.h5"))
        if not h5s:
            raise FileNotFoundError(
                f"no Keras .h5 weights for {model_name!r} under {model_dir}")
        variables = lcv.convert_experimental_h5(
            h5s[0], num_res_blocks=num_res_blocks)
        n_out = int(variables["params"]["outdense"]["bias"].shape[0])
        model = ExperimentalModel(num_classes=n_out,
                                  num_res_blocks=num_res_blocks)
        encode = encode_murphy_windows
    elif (model_dir / lcv.PARAMS_FILE).exists():
        variables = read_flax_msgpack(model_dir / lcv.PARAMS_FILE)
        model = WResModel()
        encode = encode_amino_windows
    elif (model_dir / "WRes_1024.h5").exists():
        variables = lcv.convert_wres_h5(model_dir / "WRes_1024.h5")
        model = WResModel()
        encode = encode_amino_windows
    elif (model_dir / "saved_model.pb").exists() or (
            model_dir / "variables").exists():
        variables = lcv.convert_wres_checkpoint(model_dir)
        model = WResModel()
        encode = encode_amino_windows
    else:
        raise FileNotFoundError(
            f"no {lcv.PARAMS_FILE}, WRes_1024.h5 or TF SavedModel under "
            f"{model_dir}")
    load_state(model, params_from_jax(variables))
    return model.to(resolve_device(device)).eval(), encode


def run_core(
    input_path: str,
    output_dir: str,
    model_dir: str | Path | None = None,
    fsize: int = 2048,
    stride: int = 2048,
    batch: int = 128,
    min_len: int | None = None,
    reliability_cutoff: float = 0.5,
    phage_score: float = 3,
    model_name: str = "default",
    num_res_blocks: int = 10,
    getalllabels: bool = False,
    workers: int = 4,
    device=None,
) -> Path:
    """``model_name`` routes the legacy family as the reference's
    ``LEGACY_PREDICT_MODELS`` do: ``default`` is the WRes amino model;
    ``experimental`` / ``experimental_*`` the v2 Murphy-10 architecture,
    from a Keras ``.h5`` in ``model_dir``. Runs in f32 on ``device``
    (``cuda`` by default) with TF32 off."""
    from jaeger_tpu_torch.postprocess import legacy_collect as lc
    from jaeger_tpu_torch.postprocess.termini import scan_for_terminal_repeats

    dev = resolve_device(device)
    t0 = time.time()
    input_path = Path(input_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    # the reference clamps: --min-len < --fsize is unsupported in legacy
    # mode (predict_legacy.py:58-63)
    if min_len is not None and min_len < fsize:
        logger.warning(
            "--min-len < --fsize is not supported in legacy prediction "
            f"mode; using --min-len={fsize}."
        )
    min_len = max(min_len, fsize) if min_len is not None else fsize
    model_dir = Path(model_dir) if model_dir else DEFAULT_MODEL_DIR

    validate_fasta_entries(str(input_path), min_len=min_len)
    model, encode = load_legacy_model(model_dir, model_name, num_res_blocks,
                                      dev)
    clf, batch_mean, batch_std = _load_ood(model_dir)

    logits_chunks, emb_chunks, kept = [], [], []
    with torch.inference_mode():
        for wb in window_batches(str(input_path), fragsize=fsize,
                                 stride=stride, min_len=min_len):
            kept.append(wb)
            for i in range(0, len(wb), batch):
                b = wb.bases[i: i + batch]
                ln = wb.length[i: i + batch]
                n_valid = b.shape[0]
                pad = batch - n_valid
                if pad:
                    b = np.pad(b, ((0, pad), (0, 0)), constant_values=4)
                    ln = np.pad(ln, (0, pad))
                toks = encode(torch.from_numpy(b).to(dev),
                              torch.from_numpy(ln).to(dev), fsize)
                out = model(toks)
                # kept on the device until the loop ends: one wait in all
                logits_chunks.append(out["output"][:n_valid])
                emb_chunks.append(out["embedding"][:n_valid])
        if not logits_chunks:
            raise ValueError(f"no windows produced from {input_path}")
        logits = torch.cat(logits_chunks).float().cpu().numpy()
        embeddings = torch.cat(emb_chunks).float().cpu().numpy()

    n_classes = logits.shape[1]
    canonical = lc.LEGACY_CONFIGS.get(model_name)
    if canonical is not None and canonical["num_classes"] != n_classes:
        canonical = None  # user weights with a different head size
    names = (LEGACY_LABELS if n_classes == len(LEGACY_LABELS)
             else [f"class_{i}" for i in range(n_classes)])
    config = dict(
        canonical
        or {
            "model": model_name,
            "num_classes": n_classes,
            "all_labels": dict(enumerate(names)),
            "default_labels": dict(enumerate(names)),
            "second": None,
            "vindex": 1,
        }
    )
    key = "all_labels" if getalllabels else "default_labels"
    config["labels"] = [v for _, v in config[key].items()]

    ood_params = None
    if model_name == "default" and clf is not None and batch_mean is not None:
        ood_params = {"type": "sklearn", "model": clf,
                      "batch_mean": batch_mean, "batch_std": batch_std}

    term_repeats = scan_for_terminal_repeats(
        str(input_path), fsize=fsize, workers=workers)
    meta = collect.PredictionMeta.from_batches(kept)
    data = lc.reduce_windows_legacy(
        config, logits,
        embeddings if ood_params is not None else None,
        meta, fsize=fsize, ood_params=ood_params,
        term_repeats=term_repeats,
    )
    stem = fasta_stem(input_path)
    table = output_dir / f"{stem}_{model_name}_jaeger.tsv"
    phage_table = output_dir / f"{stem}_{model_name}_phages_jaeger.tsv"
    n = lc.write_output_legacy(
        config, data, output_table_path=table,
        output_phage_table_path=phage_table,
        reliability_cutoff=reliability_cutoff, phage_score=phage_score,
    )
    dt = time.time() - t0
    logger.info(
        f"predict-legacy: {n} contigs, {logits.shape[0]} windows in "
        f"{dt:.2f}s on {dev}"
    )
    return table
