"""End-to-end prediction (PyTorch).

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
it (:func:`resolve_int8_bundle`); every template's bundle takes it.

Ensemble bundles (``ensemble.yaml``, ``utils combine-models``) load as
one :class:`jaeger_tpu_torch.models.ensemble.EnsembleModel` over their
members. ``int8`` and ``quantized`` resolve the int8 bundle first, as the
JAX CLI does, so an ensemble without a ``params_int8.msgpack`` of its own
(or an ``int8/`` or ``_int8`` beside it) raises ``FileNotFoundError``
there.

Several devices and hosts (:mod:`jaeger_tpu_torch.parallel`):
``devices`` runs the engine data-parallel over a device mesh (``"auto"``:
every visible card for a bare ``cuda``; an integer caps it; on the CPU an
integer repeats the CPU in the mesh); ``seq_shard`` rebuilds a Hyena
model with ``parallel.seq_axis`` and shards its sequence over that many
devices instead; ``mesh`` / ``seq_mesh`` pass a
:class:`~jaeger_tpu_torch.parallel.mesh.DeviceMesh` directly (a device
may repeat in it). ``num_hosts`` > 1 keeps the contigs that
:func:`~jaeger_tpu_torch.parallel.multihost.contig_owner` assigns to
``host_id`` (default: the process group's rank, else 0), writes
``<table>.shard<K>`` (an empty shard when the host owns no contig) and
per-host aux files, and the last host to finish merges the shards.
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
from jaeger_tpu_torch.models.ensemble import is_ensemble, load_ensemble
from jaeger_tpu_torch.parallel import multihost as mh
from jaeger_tpu_torch.parallel.mesh import mesh_of, visible_width
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


def crop_length_warning(config: dict, fsize: int) -> str | None:
    """Warn when ``--fsize`` disagrees with the model's trained crop.

    Copy of `jaeger_tpu/commands/predict.py::crop_length_warning`: codon
    models compare frame counts through the crop contract, nucleotide
    models compare lengths; fixed-length architectures can collapse to one
    class at an unseen length.
    """
    from jaeger_tpu_torch.models.builder import _resolve_crop_nt
    from jaeger_tpu_torch.seqops.crop import nucleotides_to_codons

    model_cfg = config.get("model", {})
    sp = model_cfg.get("string_processor", {})
    input_type = model_cfg.get("embedding", {}).get(
        "input_type", "translated")
    try:
        trained_nt = _resolve_crop_nt(sp, input_type)
    except Exception:
        return None
    if input_type == "nucleotide":
        if int(fsize) != int(trained_nt):
            return (
                f"runtime --fsize {fsize} differs from the model's "
                f"trained fragment length ({trained_nt} nt); "
                f"fixed-length architectures may degrade at a "
                f"different length — prefer --fsize {trained_nt}"
            )
        return None
    trained_codons = nucleotides_to_codons(trained_nt)
    runtime_codons = nucleotides_to_codons(int(fsize))
    if runtime_codons == trained_codons:
        return None
    effect = (
        f"windows will be zero-masked past {fsize} nt"
        if runtime_codons < trained_codons
        else f"bases past {trained_nt} nt of each window are ignored"
    )
    return (
        f"runtime --fsize {fsize} yields {runtime_codons} codon frames "
        f"but the model was trained on {trained_codons} ({trained_nt} "
        f"nt); {effect} — prefer --fsize {trained_nt}"
    )


def resolve_model_path(model: str | None,
                       registry_path: str | None = None) -> str:
    """Resolve a model argument: a bundle path, a name in the model
    registry (``registry_path``, else the default registry file), or the
    bundled demo model when omitted; as
    `jaeger_tpu/commands/predict.py::resolve_model_path`."""
    if model is None:
        logger.info(
            "no model given; using the bundled demo model "
            "(train or register a real model for production use)"
        )
        return str(BUNDLED_DEMO_MODEL)
    if Path(model).exists():
        return model
    from jaeger_tpu_torch.utils.registry import AvailableModels

    return AvailableModels(registry_path=registry_path).resolve(model)


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


def _maybe_merge_shards(output_dir: Path, stem: str,
                        num_hosts: int) -> Path | None:
    """Merge per-host TSV shards when every host's shard exists.

    Whichever host finishes last performs the merge; of two that finish
    together one merges (:func:`multihost.merge_when_complete`). Returns
    the merged table path, or None if shards are still outstanding or
    another host merges them."""
    merged = mh.merge_when_complete(
        output_dir / f"{stem}_default_jaeger.tsv", num_hosts,
        also=(output_dir / f"{stem}_default_phages_jaeger.tsv",))
    if merged is not None:
        logger.info(f"all {num_hosts} shards present; merged to {merged}")
    return merged


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
    host_id: int | None = None,
    devices: int | str = "auto",
    mesh=None,
    seq_mesh=None,
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

    # multi-host contig sharding: each host keeps the contigs a
    # deterministic hash assigns it, writes a TSV shard, and whichever
    # host finishes last merges
    contig_filter = None
    if num_hosts > 1:
        if host_id is None:
            host_id = mh.process_index()
        if not (0 <= host_id < num_hosts):
            raise ValueError(
                f"host_id {host_id} out of range for {num_hosts} hosts")
        contig_filter = (
            lambda h: mh.contig_owner(h, num_hosts) == host_id)
        logger.info(f"multi-host predict: host {host_id}/{num_hosts} "
                    f"(deterministic contig sharding)")

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

    load = load_ensemble if is_ensemble(model_path) else load_model
    model, config, classes = load(model_path, dtype=DTYPES[precision],
                                  device=dev)
    indices, labels = class_names_in_order(classes)

    # sequence sharding (--seq-shard N): the model is rebuilt with
    # parallel.seq_axis, so its Hyena blocks run length-sharded over a
    # "seq" mesh; the devices are spent on the sequence axis
    if seq_mesh is None and int(seq_shard) > 1:
        want = int(seq_shard)
        width = max(1, min(want, visible_width(dev, want)))
        if width > 1:
            seq_mesh = mesh_of(dev, width, "seq")
    if seq_mesh is not None:
        model = _with_seq_axis(model, config, DTYPES[precision], dev,
                               seq_mesh.axis)
        mesh = None
        devices = 1
        logger.info(f"sequence-sharded Hyena over {seq_mesh.size} devices "
                    f"(seq axis)")
    warning = crop_length_warning(config, fsize)
    if warning:
        logger.warning(warning)

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

    # data parallel (--devices): a 1-D data mesh; the engine pads the
    # batch to a device multiple
    if mesh is None and devices not in (1, "1"):
        want = (0 if devices in ("auto", None) else int(devices))
        n_avail = visible_width(dev, max(want, 1))
        width = n_avail if want == 0 else max(1, min(want, n_avail))
        if width > 1:
            mesh = mesh_of(dev, width, "data")
    if mesh is not None:
        logger.info(f"data-parallel inference over {mesh.size} devices")

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
                             int8_model=int8_model, mesh=mesh,
                             seq_mesh=seq_mesh)
    batches = window_batches(
        str(windowing_input), fragsize=fsize, stride=stride, min_len=min_len,
        dustmask=dustmask, dynamic_stride=dynamic_stride,
        dynamic_stride_threshold=dynamic_stride_threshold,
        contig_filter=contig_filter, workers=workers,
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
        if num_hosts > 1:
            # this host owned no windowable contigs: an empty shard keeps
            # the shard accounting complete; merge if last
            stem0 = fasta_stem(input_path)
            base = output_dir / f"{stem0}_default_jaeger.tsv"
            mh.shard_path(base, host_id).touch()
            _maybe_merge_shards(output_dir, stem0, num_hosts)
            logger.info(
                f"host {host_id} owned no contigs; empty shard written")
            return base
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
    if num_hosts > 1:
        table = mh.shard_path(table, host_id)
        phage_table = mh.shard_path(phage_table, host_id)
    # a host's shards are written aside and renamed into place, the table
    # last: the merging host takes a shard that exists as whole
    partial = {t: t.with_name(t.name + ".partial") if num_hosts > 1 else t
               for t in (table, phage_table)}
    n = collect.write_output(
        data, output_table_path=partial[table],
        output_phage_table_path=partial[phage_table],
        labels=labels or [str(i) for i in range(outputs["prediction"].shape[-1])],
        indices=indices or list(range(outputs["prediction"].shape[-1])),
        reliability_cutoff=reliability_cutoff, phage_score=phage_score,
        refined_contig=refined_contig,
    )
    for final in (phage_table, table):
        if partial[final] != final and partial[final].exists():
            partial[final].replace(final)
    if getsequences and phage_table.exists():
        out_fasta = output_dir / f"{stem}_phages_jaeger.fasta"
        collect.write_fasta_from_results(str(input_path), str(phage_table),
                                         str(out_fasta))
        logger.info(f"phage sequences written to {out_fasta}")
    if prophage:
        _prophage_stage(output_dir, stem, input_path, data_full, indices,
                        labels, fsize=fsize, stride=stride, lc=lc,
                        sensitivity=sensitivity, plot_type=plot_type)
    # a per-host suffix keeps the aux outputs of the hosts apart
    aux_suffix = f".host{host_id:03d}" if num_hosts > 1 else ""
    if save_window_scores:
        def objs(seq):
            arr = np.empty(len(seq), dtype=object)
            arr[:] = seq
            return arr

        np.savez(
            output_dir / f"{stem}_window_scores{aux_suffix}.npz",
            headers=data_full["headers"], lengths=data_full["lengths"],
            predictions=objs(data_full["predictions"]),
            gc_skews=objs(data_full["gc_skews"]), gcs=objs(data_full["gcs"]),
        )
    # per-window aux rows in the reference's order (full windows first)
    win_order = np.argsort(
        np.asarray(meta.seqlen, np.int64) < fsize, kind="stable")
    for key, flag in (("embedding", save_embedding), ("nmd", save_nmd)):
        if flag and key in outputs:
            name = "embeddings" if key == "embedding" else key
            np.savez_compressed(
                output_dir / f"{stem}_{name}{aux_suffix}.npz",
                **{key: np.asarray(outputs[key])[win_order]},
                headers=np.asarray(meta.headers, dtype=str)[win_order],
            )
    dt = time.time() - t0
    logger.info(f"predict: {n} contigs, {n_windows} windows in {dt:.2f}s "
                f"({n_windows / dt:.0f} windows/s) on {dev}")
    if num_hosts > 1:
        merged = _maybe_merge_shards(output_dir, stem, num_hosts)
        if merged is not None:
            return merged
    return table


def _with_seq_axis(model, config: dict, dtype, dev, axis: str):
    """The model rebuilt with ``model.parallel.seq_axis = axis`` and the
    same weights (the parameter tree does not depend on it)."""
    import copy

    from jaeger_tpu_torch.models.artifacts import load_state
    from jaeger_tpu_torch.models.builder import build_model

    cfg = copy.deepcopy(config)
    mcfg = cfg["model"] if "model" in cfg else cfg
    if not isinstance(mcfg.get("parallel"), dict):
        mcfg["parallel"] = {}
    mcfg["parallel"]["seq_axis"] = axis
    sharded = build_model(cfg, dtype=dtype)
    load_state(sharded, {k: v for k, v in model.state_dict().items()})
    return sharded.to(dev).eval()
