"""End-to-end prediction on one device (PyTorch).

Counterpart of `jaeger_tpu/commands/predict.py` (``run_core``): validate
the FASTA -> load the model bundle -> window the contigs -> batched device
inference -> per-contig reduction -> summary TSVs. The device-reduced path
(per-contig partial sums on the device) runs unless a consumer needs the
full per-window logits (CRF decoding, window-score NPZ, embeddings, NMD,
two-class models). The terminal-repeat scan runs beside inference.

Quantized bundles (``utils quantize``): ``int8="full"`` (``--int8``, the
same as ``quantized="full_int8"``) runs the int8 bundle's convs on the
int8 kernel; ``int8="auto"`` runs only the dense program on it and keeps
the float model for short and masked windows; ``dynamic`` and ``float16``
bundles run the float path. The int8 bundle is found as the JAX CLI finds
it (:func:`resolve_int8_bundle`).

Not ported yet, and refused with ``NotImplementedError``: sequence
sharding, multi-host sharding, ensembles, refinement, prophage
extraction, tandem-repeat masking and the profiler trace.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.infer.engine import InferenceEngine
from jaeger_tpu_torch.models.artifacts import class_names_in_order, load_model
from jaeger_tpu_torch.models.conversion import int8_conv_count
from jaeger_tpu_torch.postprocess import collect
from jaeger_tpu_torch.postprocess.termini import scan_for_terminal_repeats
from jaeger_tpu_torch.seqops.fasta import fasta_stem, validate_fasta_entries
from jaeger_tpu_torch.seqops.windows import window_batches
from jaeger_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("jaeger_tpu_torch")

#: the JAX package's bundled demo model (trained weights, read as data)
BUNDLED_DEMO_MODEL = (
    Path(__file__).resolve().parents[2] / "jaeger_tpu" / "data" / "models"
    / "demo"
)

DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    # the reference's fp16 choice maps to bf16, as in the JAX package
    "fp16": torch.bfloat16, "float16": torch.bfloat16,
}


def resolve_model_path(model: str | None) -> str:
    """A bundle path, or the bundled demo model when omitted."""
    if model is None:
        logger.info("no model given; using the bundled demo model")
        return str(BUNDLED_DEMO_MODEL)
    if not Path(model).exists():
        raise NotImplementedError(
            f"model {model!r} is not a bundle directory; the model registry "
            f"is not yet ported to jaeger_tpu_torch")
    return model


def resolve_int8_bundle(model_path: str) -> str:
    """Find the int8 bundle for a model: the bundle itself, its ``int8/``
    subdirectory, or a sibling ``<name>_int8`` directory written by
    ``utils quantize``."""
    cands = [Path(model_path), Path(model_path) / "int8",
             Path(str(model_path).rstrip("/") + "_int8")]
    for c in cands:
        # load_model only takes the int8 path when params.msgpack is
        # absent: a directory holding both would run float weights
        if (c / "params_int8.msgpack").exists() and not (
                c / "params.msgpack").exists():
            return str(c)
    raise FileNotFoundError(
        f"no int8 bundle found for '{model_path}'; create one with "
        f"'jaeger-tpu-torch utils quantize -m {model_path} -o "
        f"{model_path}_int8'")


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not yet ported to "
                               f"jaeger_tpu_torch")


def run_core(
    input_path: str,
    output_dir: str,
    model_path: str,
    fsize: int = 2000,
    stride: int = 2000,
    batch: int = 96,
    min_len: int | None = None,
    dustmask: bool = True,
    dynamic_stride: bool = False,
    dynamic_stride_threshold: float = 10.0,
    precision: str = "bfloat16",
    device=None,
    workers: int = 4,
    crf_switch_cost: float | None = None,
    crf_prior: str = "biological",
    crf_transition_matrix: dict | None = None,
    reliability_cutoff: float = 0.5,
    phage_score: float = 1.0,
    scan_termini: bool = True,
    save_window_scores: bool = False,
    getsequences: bool = False,
    save_embedding: bool = False,
    save_nmd: bool = False,
    overwrite: bool = False,
    int8: str | None = None,
    quantized: str | None = None,
    seq_shard: int = 1,
    num_hosts: int = 1,
    prophage: bool = False,
    refine: bool = False,
    mask_tandem: bool = False,
    profile: bool = False,
) -> Path:
    for flag, name in ((seq_shard > 1, "--seq-shard"),
                       (num_hosts > 1, "multi-host predict (--num-hosts)"),
                       (prophage, "--prophage"), (refine, "--refine"),
                       (mask_tandem, "--mask-tandem"),
                       (profile, "--profile")):
        if flag:
            raise _not_ported(name)
    if (Path(model_path) / "ensemble.yaml").exists():
        raise _not_ported("ensemble bundles")
    if int8 not in (None, "full", "auto"):
        raise ValueError(f"int8 must be None, 'full' or 'auto', got {int8!r}")
    if quantized not in (None, "dynamic", "full_int8", "float16"):
        raise ValueError(f"unknown quantized mode {quantized!r}")
    int8_auto_path = None
    if int8 == "auto":
        int8_auto_path = resolve_int8_bundle(model_path)
    elif int8 == "full" and quantized is None:
        quantized = "full_int8"
    if quantized in ("dynamic", "full_int8"):
        model_path = resolve_int8_bundle(model_path)
    elif quantized == "float16":
        logger.info("--quantized float16: compute uses bfloat16")
        precision = "bfloat16"
    dev = resolve_device(device)
    t0 = time.time()
    input_path = Path(input_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    existing = output_dir / f"{fasta_stem(input_path)}_default_jaeger.tsv"
    if existing.exists() and not overwrite:
        logger.error(f"output file {existing} exists; pass -f/--overwrite to "
                     f"replace it")
        raise SystemExit(1)
    min_len = min_len if min_len is not None else fsize
    validate_fasta_entries(str(input_path), min_len=min_len)

    model, config, classes = load_model(model_path, dtype=DTYPES[precision],
                                        device=dev)
    indices, labels = class_names_in_order(classes)

    term_future = None
    term_pool = None
    if scan_termini:
        # the scan re-reads the FASTA, so it overlaps windowing + inference
        from concurrent.futures import ThreadPoolExecutor

        # import pandas here, on the calling thread: a first import inside
        # the short-lived worker made a later run's DataFrame segfault
        # (pandas 3.0.3 with pyarrow 25)
        import pandas  # noqa: F401

        term_pool = ThreadPoolExecutor(max_workers=1)
        term_future = term_pool.submit(
            scan_for_terminal_repeats, str(input_path), fsize=fsize,
            workers=workers)

    wanted = ["prediction", "reliability"]
    if save_embedding:
        wanted.append("embedding")
    if save_nmd:
        wanted.append("nmd")
    int8_model = None
    if int8_auto_path is not None:
        # `--int8 auto`: the int8 bundle drives the dense program only;
        # it must be a full_int8 quantization of this model
        int8_model, _, _ = load_model(int8_auto_path,
                                      dtype=DTYPES[precision], device=dev)
        if int8_conv_count(int8_model) == 0:
            raise ValueError(
                f"--int8 auto needs a full_int8 bundle; {int8_auto_path} "
                "has no calibrated activation scales (re-run `jaeger "
                "utils quantize --mode full_int8`)")
    engine = InferenceEngine(model, batch_size=batch, device=dev,
                             output_keys=tuple(wanted),
                             int8_model=int8_model)
    batches = window_batches(
        str(input_path), fragsize=fsize, stride=stride, min_len=min_len,
        dustmask=dustmask, dynamic_stride=dynamic_stride,
        dynamic_stride_threshold=dynamic_stride_threshold, workers=workers,
    )
    needs_full = bool(
        crf_switch_cost is not None or save_window_scores or save_embedding
        or save_nmd or len(labels or []) <= 2
    )

    term_repeats = None
    try:
        if needs_full:
            result, kept = engine.predict_batches(batches)
        else:
            result, kept = engine.predict_batches_reduced(
                batches, num_classes=len(labels), with_reliability=True)
        if term_future is not None:
            term_repeats = term_future.result()
    finally:
        if term_pool is not None:
            term_pool.shutdown(wait=False, cancel_futures=True)
    if not result:
        raise ValueError(f"no windows produced from {input_path}")
    meta = collect.PredictionMeta.from_batches(kept)

    if needs_full:
        outputs = result
        n_windows = outputs["prediction"].shape[0]
        data, data_full = collect.reduce_windows(
            prediction=outputs["prediction"], meta=meta, fsize=fsize,
            num_classes=(len(labels) if labels
                         else outputs["prediction"].shape[-1]),
            reliability=outputs.get("reliability"), class_names=labels,
            crf_switch_cost=crf_switch_cost, crf_prior=crf_prior,
            crf_transition_matrix=crf_transition_matrix,
            term_repeats=term_repeats,
        )
    else:
        stats = result
        n_windows = int(sum(s["n_windows"] for s in stats.values()))
        rel_present = any("reliability" in s for s in stats.values())
        data = collect.data_from_device_stats(
            stats, meta, fsize=fsize, num_classes=len(labels),
            with_reliability=rel_present, term_repeats=term_repeats,
        )
        outputs, data_full = {}, None

    stem = fasta_stem(input_path)
    table = output_dir / f"{stem}_default_jaeger.tsv"
    phage_table = output_dir / f"{stem}_default_phages_jaeger.tsv"
    n = collect.write_output(
        data, output_table_path=table, output_phage_table_path=phage_table,
        labels=labels or [str(i) for i in range(outputs["prediction"].shape[-1])],
        indices=indices or list(range(outputs["prediction"].shape[-1])),
        reliability_cutoff=reliability_cutoff, phage_score=phage_score,
    )
    if getsequences and phage_table.exists():
        out_fasta = output_dir / f"{stem}_phages_jaeger.fasta"
        collect.write_fasta_from_results(str(input_path), str(phage_table),
                                         str(out_fasta))
        logger.info(f"phage sequences written to {out_fasta}")
    if save_window_scores:
        def objs(seq):
            arr = np.empty(len(seq), dtype=object)
            arr[:] = seq
            return arr

        np.savez(
            output_dir / f"{stem}_window_scores.npz",
            headers=data_full["headers"], lengths=data_full["lengths"],
            predictions=objs(data_full["predictions"]),
            gc_skews=objs(data_full["gc_skews"]), gcs=objs(data_full["gcs"]),
        )
    # per-window aux rows in the reference's order (full windows first)
    win_order = np.argsort(
        np.asarray(meta.seqlen, np.int64) < fsize, kind="stable")
    for key, flag in (("embedding", save_embedding), ("nmd", save_nmd)):
        if flag and key in outputs:
            np.savez_compressed(
                output_dir / f"{stem}_{'embeddings' if key == 'embedding' else key}.npz",
                **{key: np.asarray(outputs[key])[win_order]},
                headers=np.asarray(meta.headers, dtype=str)[win_order],
            )
    dt = time.time() - t0
    logger.info(f"predict: {n} contigs, {n_windows} windows in {dt:.2f}s "
                f"({n_windows / dt:.0f} windows/s) on {dev}")
    return table
