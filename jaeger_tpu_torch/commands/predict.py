"""End-to-end prediction on one device (PyTorch).

Counterpart of `jaeger_tpu/commands/predict.py` (``run_core``): validate
the FASTA -> load the model bundle -> window the contigs -> batched device
inference -> per-contig reduction -> summary TSVs. The device-reduced path
(per-contig partial sums on the device) runs unless a consumer needs the
full per-window logits (CRF decoding, prophage segmentation, refinement,
window-score NPZ, embeddings, NMD, two-class models). The terminal-repeat
scan runs beside inference.

The optional stages: ``mask_tandem`` hard-masks tandem repeats before
windowing (output names stay keyed to the original stem); ``prophage``
segments the per-window scores of contigs of at least ``lc`` nt into
prophage regions, snaps them to gene boundaries and writes the report
and plots under ``<out>/<stem>_prophages``; ``refine`` applies the
bundle's ``*_refine.yaml`` calibration to the per-contig calls;
``profile`` writes a ``torch.profiler`` Chrome trace of the inference
loop into ``<out>/profile``.

Quantized bundles (``utils quantize``): ``int8="full"`` (``--int8``, the
same as ``quantized="full_int8"``) runs the int8 bundle's convs on the
int8 kernel; ``int8="auto"`` runs only the dense program on it and keeps
the float model for short and masked windows; ``dynamic`` and ``float16``
bundles run the float path. The int8 bundle is found as the JAX CLI finds
it (:func:`resolve_int8_bundle`).

Not ported yet, and refused with ``NotImplementedError``: sequence
sharding, multi-host sharding and ensembles.
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


def _build_refined_contig_df(data_full: dict, taus: dict, mode: str = "gated",
                             min_windows: int = 3,
                             merge_split: str = "half",
                             allow_merged_contig_call: bool = False,
                             contig_hedge_margin: float = 1.0):
    """Per-contig refined calls from raw window logits.

    Copy of `jaeger_tpu/commands/predict.py::_build_refined_contig_df`:
    needs the 6-class model whose logits align with the refinement
    ``SCORE_COLS``; None when no contig qualifies.
    """
    import pandas as pd

    from jaeger_tpu_torch.postprocess import refinement as R

    predictions = data_full.get("predictions")
    headers = data_full.get("headers")
    if predictions is None or headers is None:
        return None
    rows = []
    for contig_id, logits in zip(headers, predictions):
        if logits.ndim != 2 or logits.shape[1] != len(R.SCORE_COLS):
            continue
        for window_idx, wl in enumerate(logits):
            row = {"contig_id": contig_id, "window_idx": window_idx}
            row.update(dict(zip(R.SCORE_COLS, wl)))
            rows.append(row)
    if not rows:
        return None
    window_df = R.add_score_features(pd.DataFrame(rows))
    window_df = R.refine(window_df, taus)
    agg = R.aggregate_contig(
        window_df, mode=mode, min_windows=min_windows,
        merge_split=merge_split,
        allow_merged_contig_call=allow_merged_contig_call,
        contig_hedge_margin=contig_hedge_margin,
    )
    if agg.empty:
        # every contig abstained below min_windows: the empty frame
        # carries no call columns, so keep the unrefined calls
        logger.warning(
            "refinement left no contig with >= %d confident windows; "
            "summary keeps the unrefined calls", min_windows)
        return None
    return agg


def _refined_calls(model_path: str, config: dict, data_full: dict,
                   **options):
    """The refinement stage: the bundle's ``<name>_refine.yaml`` (or any
    ``*_refine.yaml`` in it) applied to the window logits; None, with a
    warning, when there is no calibration or it fails."""
    refine_path = Path(model_path) / (
        f"{config.get('model', {}).get('name', 'model')}_refine.yaml")
    if not refine_path.exists():
        candidates = list(Path(model_path).glob("*_refine.yaml"))
        refine_path = candidates[0] if candidates else refine_path
    if not refine_path.exists():
        logger.warning(f"no refinement calibration at {refine_path}")
        return None
    from jaeger_tpu_torch.postprocess import refinement as R

    try:
        refine_cfg = R.load_refinement(refine_path)
        refined = _build_refined_contig_df(data_full, refine_cfg["taus"],
                                           **options)
    except Exception as e:
        logger.warning(f"refinement failed: {e}; using defaults")
        return None
    logger.info(f"applied refinement from {refine_path}")
    return refined


def _prophage_stage(output_dir: Path, stem: str, input_path: Path,
                    data_full: dict, indices, labels, fsize: int,
                    stride: int, lc: int, sensitivity: float,
                    plot_type: str) -> None:
    """Prophage segmentation, gene-snapped boundaries, the att report and
    the plots, as `jaeger_tpu/commands/predict.py` runs them."""
    from jaeger_tpu_torch.postprocess import prophages as pro
    from jaeger_tpu_torch.postprocess.genes import refine_prophage_boundaries

    logits_df = pro.logits_to_df_v2(
        class_map={"index": indices, "class": labels},
        cmdline_kwargs={"lc": lc, "fsize": fsize, "stride": stride},
        headers=data_full["headers"], predictions=data_full["predictions"],
        lengths=data_full["lengths"], gc_skews=data_full["gc_skews"],
        gcs=data_full["gcs"],
    )
    if not logits_df:
        logger.info("no prophage regions found")
        return
    logger.info("identifying prophages")
    pro_dir = output_dir / f"{stem}_prophages"
    plots_dir = pro_dir / "plots"
    plots_dir.mkdir(parents=True, exist_ok=True)
    phage_cord = pro.segment(logits_df, outdir=plots_dir, cutoff_length=lc,
                             sensitivity=sensitivity, identifier="phage")
    refined = refine_prophage_boundaries(
        prophage_cordinates=phage_cord, fasta_path=input_path, fsize=fsize,
        stride=stride)
    plot_kw = dict(fsize=fsize, infile_base=stem, outdir=plots_dir,
                   phage_cordinates=phage_cord, stride=stride)
    if plot_type in ("circular", "both"):
        pro.plot_scores(logits_df, **plot_kw)
    if plot_type in ("linear", "both"):
        pro.plot_scores_linear(logits_df, **plot_kw)
    pro.prophage_report(
        fsize=fsize, filehandle=input_path, prophage_cordinates=phage_cord,
        outdir=pro_dir, refined_boundaries=refined, stride=stride,
        cutoff_length=lc)


def _not_ported(option: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{option} is not yet ported to "
                               f"jaeger_tpu_torch (ROADMAP.md queue 1, "
                               f"item {item})")


def _profiled(run, trace_dir: Path, dev: torch.device):
    """``run()`` under ``torch.profiler`` (CUDA activity on the card); the
    Chrome trace goes to ``trace_dir/predict_trace.json``, with the loop
    inside a ``predict.inference`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("predict.inference"):
            out = run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / "predict_trace.json"
    prof.export_chrome_trace(str(trace))
    logger.info(f"profiler trace written to {trace}")
    return out


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
    sensitivity: float = 1.5,
    lc: int = 500_000,
    plot_type: str = "circular",
    refine: bool = False,
    refine_mode: str = "gated",
    refine_min_windows: int = 3,
    refine_merge_split: str = "half",
    refine_allow_merged_contig_call: bool = False,
    refine_contig_hedge_margin: float = 1.0,
    mask_tandem: bool = False,
    profile: bool = False,
) -> Path:
    for flag, name in ((seq_shard > 1, "--seq-shard"),
                       (num_hosts > 1, "multi-host predict (--num-hosts)")):
        if flag:
            raise _not_ported(name, 14)
    if (Path(model_path) / "ensemble.yaml").exists():
        raise _not_ported("ensemble bundles", 13)
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

    windowing_input = input_path
    if mask_tandem:
        # hard-mask tandem repeats before windowing; output names stay
        # keyed to the original stem
        from jaeger_tpu_torch.seqops.tandem import mask_fasta

        masked_path = (output_dir
                       / f"{fasta_stem(input_path)}_tandem_masked.fasta")
        n_masked = mask_fasta(str(input_path), str(masked_path),
                              workers=workers)
        logger.info(f"tandem-repeat pre-mask: {n_masked} bases masked "
                    f"-> {masked_path.name}")
        windowing_input = masked_path

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
            scan_for_terminal_repeats, str(windowing_input), fsize=fsize,
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
        str(windowing_input), fragsize=fsize, stride=stride, min_len=min_len,
        dustmask=dustmask, dynamic_stride=dynamic_stride,
        dynamic_stride_threshold=dynamic_stride_threshold, workers=workers,
    )
    needs_full = bool(
        crf_switch_cost is not None or prophage or save_window_scores
        or refine or save_embedding or save_nmd or len(labels or []) <= 2
    )

    def run_engine():
        if needs_full:
            return engine.predict_batches(batches)
        return engine.predict_batches_reduced(
            batches, num_classes=len(labels), with_reliability=True)

    term_repeats = None
    try:
        if profile:
            result, kept = _profiled(run_engine, output_dir / "profile", dev)
        else:
            result, kept = run_engine()
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

    refined_contig = None
    if refine:
        refined_contig = _refined_calls(
            model_path, config, data_full, mode=refine_mode,
            min_windows=refine_min_windows, merge_split=refine_merge_split,
            allow_merged_contig_call=refine_allow_merged_contig_call,
            contig_hedge_margin=refine_contig_hedge_margin)

    stem = fasta_stem(input_path)
    table = output_dir / f"{stem}_default_jaeger.tsv"
    phage_table = output_dir / f"{stem}_default_phages_jaeger.tsv"
    n = collect.write_output(
        data, output_table_path=table, output_phage_table_path=phage_table,
        labels=labels or [str(i) for i in range(outputs["prediction"].shape[-1])],
        indices=indices or list(range(outputs["prediction"].shape[-1])),
        reliability_cutoff=reliability_cutoff, phage_score=phage_score,
        refined_contig=refined_contig,
    )
    if getsequences and phage_table.exists():
        out_fasta = output_dir / f"{stem}_phages_jaeger.fasta"
        collect.write_fasta_from_results(str(input_path), str(phage_table),
                                         str(out_fasta))
        logger.info(f"phage sequences written to {out_fasta}")
    if prophage:
        _prophage_stage(output_dir, stem, input_path, data_full, indices,
                        labels, fsize=fsize, stride=stride, lc=lc,
                        sensitivity=sensitivity, plot_type=plot_type)
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
