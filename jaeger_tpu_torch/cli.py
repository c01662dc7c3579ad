"""jaeger_tpu_torch command-line interface.

Counterpart of `jaeger_tpu/cli.py`: ``predict``, with the JAX command's
options for the modern-model path (``--int8 [full|auto]``,
``--quantized``, ``--prophage`` with ``-s/--sensitivity``, ``--lc`` and
``--plot-type``, ``--refine`` with the ``--refine-*`` options,
``--mask-tandem``, ``--profile``, ``--model_path``, ``--config`` (the model
registry), ``--getalllabels``, the device flags ``--cpu``,
``--physicalid``, ``--mem``, ``--xla``, and ``--devices``,
``--seq-shard``, ``--num-hosts``, ``--host-id`` included) plus
``--device``;
``predict -m default|experimental[_N]`` (without ``--model_path``) runs the
legacy workflow with ``predict``'s defaults, as JAX's CLI does;
``predict-legacy``; ``train`` (fragment models; ``--coordinator``,
``--num-processes`` and ``--process-id`` run it data-parallel over a
``torch.distributed`` process group: nccl on CUDA, gloo on the CPU);
``health``; ``taxonomy build|predict``; ``register-models``,
``list-models`` and ``download``; and the ``utils`` commands
(``optimize-data``, ``fragment``, ``mask-tandem``, ``mask``, ``convert``,
``stats``, ``split``, ``ood-data``, ``receptive-field``, ``dataset``,
``quantize``, ``combine-models``, ``convert-weights``, ``convert-graph``).
Commands that run a model take ``--device`` (``cuda`` by default; ``cpu``
runs on the CPU). A usage error exits 2 with its message,
and a command error exits 1 with ``Error: <message>``, as click does.
Built on ``argparse`` so the CLI needs nothing beyond the standard library.

    python -m jaeger_tpu_torch.cli health
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/ \
        -m default
    python -m jaeger_tpu_torch.cli predict-legacy -i contigs.fasta -o out/
    python -m jaeger_tpu_torch.cli register-models -p model/
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/ \
        -m <registered name>
    python -m jaeger_tpu_torch.cli taxonomy build -m model -i refs.fasta \
        -a acc2taxid.tsv -t taxdump/ -o taxdb/
    python -m jaeger_tpu_torch.cli taxonomy predict -m model -d taxdb/ \
        -i contigs.fasta -o taxonomy.tsv
    python -m jaeger_tpu_torch.cli utils optimize-data -i train.csv \
        -o train.npz
    python -m jaeger_tpu_torch.cli utils quantize -m model -o model_int8 \
        --mode full_int8
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/ \
        -m model --int8 auto
    python -m jaeger_tpu_torch.cli train -c config.yaml -o model/
    python -m jaeger_tpu_torch.cli utils combine-models -i model_a \
        -i model_b -o ensemble -c mv
    python -m jaeger_tpu_torch.cli utils convert-weights -i WRes_1024.h5 \
        -o wres/
    python -m jaeger_tpu_torch.cli utils convert-graph -m model \
        -o model.pt2 --precision float32
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

logger = logging.getLogger("jaeger_tpu_torch")

#: ``-m`` names that route ``predict`` to the legacy workflow
LEGACY_MODELS = ("default", "experimental", "experimental_1",
                 "experimental_2")


class CommandError(Exception):
    """A command's error: ``main`` prints ``Error: <message>`` and exits
    1, as click does for ``ClickException``."""


def _add_device_flags(p: argparse.ArgumentParser) -> None:
    """JAX's device flags, plus ``--device``."""
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the "
                        "CPU).")
    p.add_argument("--cpu", action="store_true",
                   help="Ignore accelerators and explicitly run on CPU.")
    p.add_argument("--physicalid", type=int, default=0,
                   help="Device index on multi-device hosts (cuda:N).")
    p.add_argument("--mem", type=int, default=4,
                   help="Accelerator memory limit in GB (accepted and "
                        "ignored).")
    p.add_argument("--xla", action="store_true",
                   help="XLA JIT (accepted for compatibility and ignored).")


def _device_from_flags(args: argparse.Namespace,
                       parser: argparse.ArgumentParser) -> str:
    """The torch device the flags name, as JAX's ``_apply_device_flags``
    maps them: ``--cpu`` selects the CPU; ``--physicalid N`` selects
    ``cuda:N`` (a usage error unless N is below the device count);
    ``--mem`` and ``--xla`` are logged as ignored."""
    if args.cpu:
        return "cpu"
    if args.xla:
        logger.info("--xla: there is no JIT step here; ignored")
    if args.mem not in (None, 4):
        logger.info("--mem: device memory is managed by PyTorch's "
                    "allocator; ignored")
    if args.physicalid:
        import torch

        n = torch.cuda.device_count()
        if args.physicalid >= n:
            parser.error(f"--physicalid {args.physicalid}: only {n} "
                         f"device(s)")
        return f"cuda:{args.physicalid}"
    return args.device


def _predict_parser(sub) -> None:
    p = sub.add_parser("predict", help="Identify phage sequences in a FASTA "
                                       "of contigs.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_dir", required=True)
    p.add_argument("-m", "--model", dest="model_path", default=None,
                   help="Model bundle directory (default: the bundled demo "
                        "model); 'default' / 'experimental[_N]' run the "
                        "legacy workflow.")
    p.add_argument("--model_path", dest="model_path_override", default=None,
                   help="Path to a model bundle; overrides --model.")
    p.add_argument("--config", dest="registry_config", default=None,
                   help="Model-registry config file (e.g. inside "
                        "containers).")
    p.add_argument("--fsize", type=int, default=2000)
    p.add_argument("--stride", type=int, default=1500)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--min-len", dest="min_len", type=int, default=None)
    p.add_argument("--dustmask", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--dynamic-stride", action="store_true")
    p.add_argument("--dynamic-stride-threshold", type=float, default=10.0)
    p.add_argument("--precision", default="bfloat16",
                   choices=["bfloat16", "float32", "bf16", "fp32", "fp16",
                            "float16"])
    _add_device_flags(p)
    p.add_argument("--onnx", action="store_true",
                   help="ONNX Runtime engine (not available).")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--crf", action="store_true")
    p.add_argument("--crf-switch-cost", type=float, default=2.0)
    p.add_argument("--crf-prior", default="biological",
                   choices=["biological", "uniform"])
    p.add_argument("--crf-transition-matrix", default=None)
    p.add_argument("--rc", "--reliability-cutoff", dest="reliability_cutoff",
                   type=float, default=0.1)
    p.add_argument("--pc", "--phage-score", dest="phage_score", type=float,
                   default=3.0)
    p.add_argument("--no-termini", action="store_true")
    p.add_argument("--window-scores", action="store_true")
    p.add_argument("--getsequences", action="store_true")
    p.add_argument("--save-embedding", action="store_true")
    p.add_argument("--save-nmd", action="store_true")
    p.add_argument("-f", "--overwrite", action="store_true")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--getalllabels", action="store_true",
                   help="Legacy models: report per-class labels for "
                        "non-phage contigs.")
    p.add_argument("--int8", nargs="?", const="full", default=None,
                   choices=["full", "auto"],
                   help="Use the int8 bundle (utils quantize --mode "
                        "full_int8): bare --int8 (= full) runs every "
                        "calibrated conv on the int8 kernel; '--int8 auto' "
                        "only the dense program (full-length unambiguous "
                        "windows), keeping short and masked windows on "
                        "the float model.")
    p.add_argument("--quantized", default=None,
                   choices=["dynamic", "float16", "full_int8"],
                   help="Use a quantized bundle: dynamic / full_int8 load "
                        "the int8 bundle; float16 selects bf16 compute.")
    p.add_argument("-p", "--prophage", action="store_true",
                   help="Extract and report prophage-like regions.")
    p.add_argument("-s", "--sensitivity", type=float, default=1.5,
                   help="Sensitivity of the prophage extraction (0-4).")
    p.add_argument("--lc", type=int, default=500_000,
                   help="Minimum contig length for prophage extraction.")
    p.add_argument("--plot-type", default="circular",
                   choices=["circular", "linear", "both", "none"])
    p.add_argument("--refine", action="store_true",
                   help="Apply post-hoc refinement calibration if present.")
    p.add_argument("--refine-mode", default="gated",
                   choices=["gated", "weighted", "unweighted"])
    p.add_argument("--refine-min-windows", type=int, default=3,
                   help="Minimum accepted windows for a refined contig "
                        "call.")
    p.add_argument("--refine-merge-split", default="half",
                   choices=["half", "full"],
                   help="Share of a merged-class window's weight given to "
                        "each member class.")
    p.add_argument("--refine-allow-merged-contig-call", action="store_true",
                   help="Allow hedged merged-class contig calls when the "
                        "top-two margin is small.")
    p.add_argument("--refine-contig-hedge-margin", type=float, default=1.0,
                   help="Margin below which a contig call is hedged to the "
                        "merged class.")
    p.add_argument("--mask-tandem", action="store_true",
                   help="Hard-mask tandem repeats before windowing.")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace of the inference "
                        "loop into <output>/profile.")
    p.add_argument("--devices", default="auto",
                   help="Data-parallel device count: 'auto' uses every "
                        "visible card, an integer caps it (1 disables the "
                        "mesh).")
    p.add_argument("--seq-shard", type=int, default=1,
                   help="Shard the sequence length of Hyena long "
                        "convolutions over N devices (full-contig models). "
                        "Excludes data parallelism; outputs are identical "
                        "to --seq-shard 1.")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="Shard contigs deterministically across N "
                        "independent host processes; each writes a TSV "
                        "shard and the last to finish merges.")
    p.add_argument("--host-id", type=int, default=None,
                   help="This process's shard index in [0, num-hosts); "
                        "defaults to the process group's rank, else 0.")
    p.set_defaults(handler=predict, parser=p)


def predict(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    from jaeger_tpu_torch.commands.predict import (resolve_int8_bundle,
                                                   resolve_model_path,
                                                   run_core)

    device = _device_from_flags(args, parser)
    if args.onnx:
        parser.error(
            "--onnx: the engine zoo is replaced by a single XLA path "
            "here (see docs/optimizations.md); use --quantized full_int8 "
            "for the int8 bundle.")
    devices = "auto"
    if args.devices != "auto":
        try:
            devices = int(args.devices)
        except ValueError:
            parser.error(f"--devices {args.devices!r}: 'auto' or an integer")
    if args.registry_config is not None and not Path(
            args.registry_config).exists():
        parser.error(f"--config {args.registry_config!r}: no such file")

    if (args.model_path_override is None
            and args.model_path in LEGACY_MODELS):
        print(f"Warning: model '{args.model_path}' uses the legacy "
              "prediction workflow and is deprecated.", file=sys.stderr)
        from jaeger_tpu_torch.commands.predict_legacy import (
            run_core as legacy_run_core)

        table = legacy_run_core(
            input_path=args.input_path, output_dir=args.output_dir,
            fsize=args.fsize, stride=args.stride, batch=args.batch,
            min_len=args.min_len, reliability_cutoff=args.reliability_cutoff,
            phage_score=args.phage_score, model_name=args.model_path,
            getalllabels=args.getalllabels, workers=args.workers,
            device=device)
        print(f"summary written to {table}")
        return
    try:
        model_path = (args.model_path_override
                      or resolve_model_path(
                          args.model_path,
                          registry_path=args.registry_config))
    except FileNotFoundError as e:
        raise CommandError(str(e)) from e
    if args.int8 or args.quantized in ("dynamic", "full_int8"):
        # JAX's CLI raises click.UsageError here: exit 2 with the message
        try:
            resolve_int8_bundle(model_path)
        except FileNotFoundError as e:
            parser.error(str(e))
    crf_matrix = None
    if args.crf_transition_matrix:
        with open(args.crf_transition_matrix) as fh:
            crf_matrix = json.load(fh)
    table = run_core(
        input_path=args.input_path, output_dir=args.output_dir,
        model_path=model_path, fsize=args.fsize, stride=args.stride, batch=args.batch,
        min_len=args.min_len, dustmask=args.dustmask,
        dynamic_stride=args.dynamic_stride,
        dynamic_stride_threshold=args.dynamic_stride_threshold,
        precision=args.precision, device=device, workers=args.workers,
        crf_switch_cost=args.crf_switch_cost if args.crf else None,
        crf_prior=args.crf_prior, crf_transition_matrix=crf_matrix,
        reliability_cutoff=args.reliability_cutoff,
        phage_score=args.phage_score, scan_termini=not args.no_termini,
        save_window_scores=args.window_scores,
        getsequences=args.getsequences, save_embedding=args.save_embedding,
        save_nmd=args.save_nmd, overwrite=args.overwrite,
        int8=args.int8, quantized=args.quantized, seq_shard=args.seq_shard,
        num_hosts=args.num_hosts, host_id=args.host_id, devices=devices,
        prophage=args.prophage,
        sensitivity=args.sensitivity, lc=args.lc, plot_type=args.plot_type,
        refine=args.refine, refine_mode=args.refine_mode,
        refine_min_windows=args.refine_min_windows,
        refine_merge_split=args.refine_merge_split,
        refine_allow_merged_contig_call=args.refine_allow_merged_contig_call,
        refine_contig_hedge_margin=args.refine_contig_hedge_margin,
        mask_tandem=args.mask_tandem, profile=args.profile,
    )
    print(f"summary written to {table}")


def _predict_legacy_parser(sub) -> None:
    p = sub.add_parser("predict-legacy",
                       help="Legacy predict: the default WRes model or a v2 "
                            "experimental model.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_dir", required=True)
    p.add_argument("-m", "--model-dir", dest="model_dir", default=None,
                   help="Directory with the model (default: the shipped "
                        "default bundle; a WRes_1024.h5 + OOD pickle, or an "
                        "experimental Keras .h5).")
    p.add_argument("--fsize", type=int, default=2048)
    p.add_argument("--stride", type=int, default=2048)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--min-len", dest="min_len", type=int, default=None)
    p.add_argument("--model", dest="model_name", default="default",
                   help="Legacy family: 'default' (the WRes model) or "
                        "'experimental[_N]' (v2 Murphy-10 model; needs a "
                        "Keras .h5 in --model-dir).")
    p.add_argument("--num-res-blocks", dest="num_res_blocks", type=int,
                   default=10,
                   help="Residual blocks in the experimental tower.")
    p.add_argument("--rc", "--reliability-cutoff", dest="reliability_cutoff",
                   type=float, default=0.5)
    p.add_argument("--pc", "--phage-score", dest="phage_score", type=float,
                   default=3.0)
    p.add_argument("--getalllabels", action="store_true",
                   help="Report per-class labels for non-phage contigs.")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the "
                        "CPU).")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.set_defaults(handler=predict_legacy, parser=p)


def predict_legacy(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.predict_legacy import run_core

    table = run_core(input_path=args.input_path, output_dir=args.output_dir,
                     model_dir=args.model_dir, fsize=args.fsize,
                     stride=args.stride, batch=args.batch,
                     min_len=args.min_len, model_name=args.model_name,
                     num_res_blocks=args.num_res_blocks,
                     reliability_cutoff=args.reliability_cutoff,
                     phage_score=args.phage_score,
                     getalllabels=args.getalllabels, workers=args.workers,
                     device=args.device)
    print(f"summary written to {table}")


def _train_parser(sub) -> None:
    p = sub.add_parser("train", help="Train a fragment classifier from a "
                                     "YAML config.")
    p.add_argument("-c", "--config", dest="config_path", required=True)
    p.add_argument("-o", "--output", dest="output_dir", default=None)
    p.add_argument("--epochs", type=int, default=None,
                   help="Override classifier epochs.")
    p.add_argument("--steps-per-epoch", "--steps_per_epoch",
                   dest="steps_per_epoch", type=int, default=None)
    p.add_argument("--from-last-checkpoint", "--from_last_checkpoint",
                   dest="from_last_checkpoint", action="store_true",
                   help="Resume from the most advanced branch checkpoint.")
    p.add_argument("-f", "--force", action="store_true",
                   help="Train into a non-empty output directory anyway.")
    p.add_argument("--ignore-convergence", "--ignore_convergence",
                   dest="ignore_convergence", action="store_true",
                   help="Retrain branches even if convergence markers "
                        "exist.")
    p.add_argument("--only-classification-head", "--only-heads",
                   "--only_classification_head", "--only_heads",
                   dest="only_classification_head", action="store_true",
                   help="Freeze the representation learner; fine-tune heads "
                        "only.")
    p.add_argument("--only-reliability-head", "--only_reliability_head",
                   dest="only_reliability_head", action="store_true",
                   help="Skip the classifier; train the reliability branch "
                        "only.")
    p.add_argument("--only-save", "--only_save", dest="only_save",
                   action="store_true",
                   help="Save the model with last-checkpoint weights without "
                        "training.")
    p.add_argument("--masking", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Enable/disable sequence masking; defaults to "
                        "model.use_masking in the config.")
    p.add_argument("--precision", default=None,
                   type=str.lower, choices=["fp32", "fp16", "bf16"],
                   help="Numeric precision (overrides "
                        "training.mixed_precision; fp16 maps to bf16).")
    p.add_argument("--meta", default=None,
                   help="Path to write container metadata JSON.")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the "
                        "CPU).")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--self-supervised-pretraining",
                   "--self_supervised_pretraining",
                   dest="self_supervised_pretraining", action="store_true",
                   help="Run the ArcFace projection pretraining branch "
                        "first.")
    p.add_argument("--generate-reliability-data",
                   "--generate_reliability_data",
                   dest="generate_reliability_data", action="store_true",
                   default=None,
                   help="Generate ID/OOD reliability data with the "
                        "classifier.")
    p.add_argument("--id-threshold", "--id_threshold", dest="id_threshold",
                   type=float, default=None,
                   help="Reliability data: confidence above which a correct "
                        "prediction counts as in-distribution.")
    p.add_argument("--synthetic-ood-threshold", "--synthetic_ood_threshold",
                   dest="synthetic_ood_threshold", type=float, default=None,
                   help="Reliability data: confidence above which a "
                        "synthetic corrupted sequence is kept as OOD.")
    p.add_argument("--synthetic-ood-multiplier",
                   "--synthetic_ood_multiplier",
                   dest="synthetic_ood_multiplier", type=float, default=None,
                   help="Reliability data: synthetic sequences generated per "
                        "real record (overrides the config).")
    p.add_argument("--coordinator", default=None,
                   help="Multi-process training: the process group's "
                        "HOST:PORT (run one process per card with "
                        "--num-processes/--process-id; batch rows shard "
                        "over the processes, process 0 writes artifacts).")
    p.add_argument("--num-processes", "--num_processes",
                   dest="num_processes", type=int, default=None,
                   help="Multi-process training: total process count.")
    p.add_argument("--process-id", "--process_id", dest="process_id",
                   type=int, default=None,
                   help="Multi-process training: this process's index.")
    p.set_defaults(handler=train, parser=p)


def train(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.train import train_fragment_core

    device = args.device
    if args.coordinator:
        # join the process group before any device use; with a bare
        # `cuda` each process takes its own card
        from jaeger_tpu_torch.parallel import multihost as mh

        if args.num_processes is None or args.process_id is None:
            parser.error("--coordinator needs --num-processes and "
                         "--process-id")
        device = str(mh.rank_device(device, args.process_id))
        if device.startswith("cuda"):
            import torch

            torch.cuda.set_device(torch.device(device))
        pid, nproc = mh.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device=device)
        print(f"torch.distributed: process {pid}/{nproc} on {device}",
              file=sys.stderr)
    elif (args.num_processes or 1) > 1:
        parser.error("--num-processes above 1 needs --coordinator")
    try:
        results = train_fragment_core(
            config_path=args.config_path, output_dir=args.output_dir,
            epochs_override=args.epochs,
            steps_override=args.steps_per_epoch,
            self_supervised_pretraining=args.self_supervised_pretraining,
            generate_reliability=args.generate_reliability_data,
            from_last_checkpoint=args.from_last_checkpoint,
            force=args.force, ignore_convergence=args.ignore_convergence,
            only_classification_head=args.only_classification_head,
            only_reliability_head=args.only_reliability_head,
            only_save=args.only_save, id_threshold=args.id_threshold,
            synthetic_ood_threshold=args.synthetic_ood_threshold,
            synthetic_ood_multiplier=args.synthetic_ood_multiplier,
            masking=args.masking, precision=args.precision, meta=args.meta,
            device=device)
    finally:
        if args.coordinator:
            mh.shutdown_distributed()
    print(f"model written to {results.get('model_path')}")


def _utils_parser(sub) -> None:
    p = sub.add_parser("utils", help="Model utilities and training-data "
                                     "tooling.")
    usub = p.add_subparsers(dest="utils_command", required=True)
    q = usub.add_parser("quantize",
                        help="Write a quantized variant of a model bundle.")
    q.add_argument("-m", "--model", dest="model_path", required=True)
    q.add_argument("-o", "--output", dest="output_path", required=True)
    q.add_argument("--mode", default="dynamic",
                   choices=["dynamic", "float16", "full_int8"],
                   help="dynamic: int8 per-channel weight bundle "
                        "(dequantized at load); full_int8: weights int8 + "
                        "calibrated activation scales -> int8 execution at "
                        "predict time; float16: bfloat16-weight bundle.")
    q.add_argument("--device", default="cuda",
                   help="torch device for full_int8 calibration (default "
                        "cuda; 'cpu' runs on the CPU).")
    q.add_argument("-v", "--verbose", action="count", default=0)
    q.set_defaults(handler=quantize, parser=q)
    c = usub.add_parser("combine-models",
                        help="Combine N trained model bundles into an "
                             "ensemble bundle.")
    c.add_argument("model_paths", nargs="*")
    c.add_argument("-i", "--input", dest="input_paths", action="append",
                   default=[], help="Path to a saved model (repeatable).")
    c.add_argument("-o", "--output", dest="output_path", required=True)
    c.add_argument("-c", "--comb", "--method", dest="method",
                   default="mean", type=str.lower,
                   choices=["mv", "sum", "mean", "none"])
    c.add_argument("--device", default="cuda",
                   help="torch device the members are loaded on to check "
                        "them (default cuda; 'cpu' runs on the CPU).")
    c.add_argument("-v", "--verbose", action="count", default=0)
    c.set_defaults(handler=combine_models, parser=c)
    _data_parsers(usub)


def _existing(parser: argparse.ArgumentParser, path: str | None, flag: str,
              file_only: bool = False) -> None:
    """click.Path(exists=True)'s check: a usage error when ``path`` is
    missing (or, with ``file_only``, a directory)."""
    if path is None:
        return
    p = Path(path)
    if not p.exists():
        parser.error(f"{flag}: path {path!r} does not exist")
    if file_only and p.is_dir():
        parser.error(f"{flag}: {path!r} is a directory")


def quantize(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.models.conversion import quantize_bundle

    print(quantize_bundle(args.model_path, args.output_path, mode=args.mode,
                          device=args.device))


def combine_models(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.models.ensemble import combine_models_core

    paths = list(args.input_paths) + list(args.model_paths)
    if not paths:
        raise SystemExit("provide model paths (-i, repeatable)")
    for mp in paths:
        if not Path(mp).exists():
            raise SystemExit(f"model path {mp!r} does not exist")
    out = combine_models_core(paths, args.output_path, args.method,
                              device=args.device)
    print(f"ensemble bundle written to {out}")


# --- utils: the data commands (`jaeger_tpu/cli.py:300-888`) -----------------

def _data_parsers(usub) -> None:
    p = usub.add_parser("optimize-data",
                        help="Convert a label,sequence CSV to a "
                             "preprocessed NPZ dataset.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--format", dest="fmt", default="translated",
                   choices=["translated", "nucleotide", "both"])
    p.add_argument("--crop-size", dest="crop_size", type=int,
                   action="append", default=None,
                   help="Crop size (repeatable; default 500).")
    p.add_argument("--units", default="nuc", type=str.lower,
                   choices=["nuc", "codon"],
                   help="Units for --crop-size and --stride.")
    p.add_argument("--stride", type=int, default=0)
    p.add_argument("--overlap", type=float, default=None,
                   help="Overlap between crops as a fraction of each crop "
                        "size (0-1); overrides --stride.")
    p.add_argument("--one-hot", action="store_true")
    p.add_argument("--codon-map", default="codon_id")
    p.add_argument("--nucleotide-map", default=None,
                   help='JSON mapping for A, C, G, T, N (default: '
                        '{"A":1,"G":2,"T":3,"C":4,"N":0}).')
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--pad-int", type=int, default=0,
                   help="Padding value for integer outputs.")
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "int8", "uint8", "int16", "int32"],
                   help="Integer dtype for encoded features (auto picks "
                        "the smallest fitting dtype).")
    p.add_argument("--max-length", type=int, default=5000,
                   help="Deprecated and ignored.")
    p.add_argument("--max-memory-mb", type=int, default=None,
                   help="Memory budget; larger datasets stream as shards.")
    p.add_argument("--compress", default="fast",
                   choices=["default", "none", "fast"])
    p.add_argument("--pad", action="store_true",
                   help="Pad all crops to the maximum length (dense "
                        "arrays) instead of ragged per-crop arrays.")
    p.add_argument("--balance-classes", action="store_true")
    p.add_argument("--shuffle-seed", type=int, default=42,
                   help="Seed for the within-class shuffle used with "
                        "--balance-classes.")
    p.add_argument("--shard-size", type=int, default=None,
                   help="Stream output as class-balanced shards of this "
                        "size.")
    p.add_argument("--workers", "--num-workers", dest="workers", type=int,
                   default=4,
                   help="Thread workers for shard/chunk materialization.")
    p.set_defaults(handler=optimize_data, parser=p)

    p = usub.add_parser("fragment", help="Fragment a FASTA into windows.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--fsize", type=int, default=2000)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--min-len", dest="min_len", type=int, default=None)
    p.add_argument("--label", type=int, default=None)
    p.add_argument("--minlen", type=int, default=None,
                   help="Min fragment size (random-length fragments via "
                        "the splitter).")
    p.add_argument("--maxlen", type=int, default=None,
                   help="Max fragment size (with --minlen).")
    p.add_argument("--overlap", type=int, default=0,
                   help="Overlap between fragments (with --minlen).")
    p.add_argument("--shuffle", action="store_true",
                   help="Shuffle the emitted fragments (with --minlen).")
    p.set_defaults(handler=fragment, parser=p)

    p = usub.add_parser("mask-tandem",
                        help="Hard-mask tandem repeats to N.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--minscore", type=int, default=None,
                   help="Minimum repeat alignment score (TRF default 50).")
    p.add_argument("--maxperiod", type=int, default=None,
                   help="Maximum repeat period (TRF default 500).")
    p.add_argument("--workers", type=int, default=None,
                   help="Parallel records (default: thread-pool default).")
    p.set_defaults(handler=mask_tandem, parser=p)

    p = usub.add_parser("mask", help="Progressive masking/mutation series "
                                     "for robustness testing.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--minperc", type=float, default=0.0)
    p.add_argument("--maxperc", type=float, default=1.0)
    p.add_argument("--step", type=float, default=0.01)
    p.add_argument("--mutate", action="store_true",
                   help="Replace with random bases instead of N-masking.")
    p.add_argument("--seed", type=int, default=None,
                   help="Seed for reproducible position/base draws.")
    p.set_defaults(handler=mask, parser=p)

    p = usub.add_parser("convert", help="Convert between CSV "
                                        "(class,sequence,id) and FASTA.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--itype", required=True, type=str.upper,
                   choices=["CSV", "FASTA"])
    p.set_defaults(handler=convert, parser=p)

    p = usub.add_parser("stats", help="Summary statistics (and plots) for "
                                      "a prediction TSV.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_dir", default=None,
                   help="Directory for the plots and "
                        "jaeger_output_with_pvals.tsv.")
    p.set_defaults(handler=stats, parser=p)

    p = usub.add_parser("split", help="Simulate metagenome assemblies by "
                                      "fragment sampling.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--minlen", type=int, default=2000)
    p.add_argument("--maxlen", type=int, default=5000)
    p.add_argument("--overlap", type=int, default=0)
    p.add_argument("--coverage", type=float, default=None)
    p.add_argument("--circular", action="store_true")
    p.add_argument("--max-n-prop", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--shuffle", action="store_true")
    p.set_defaults(handler=split, parser=p)

    p = usub.add_parser("ood-data",
                        help="Build a shuffled-negative OOD dataset.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-ip", "--input_predictions", dest="input_predictions",
                   default=None,
                   help="Predictions TSV for the input; only correctly "
                        "predicted contigs keep label 1.")
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--method", default="dinuc",
                   choices=["dinuc", "kmer", "random"])
    p.add_argument("--dinuc", dest="dinuc_flag", action="store_true",
                   help="Dinucleotide shuffle (same as --method dinuc).")
    p.add_argument("-k", "--kmer", type=int, default=2,
                   help="k-mer size for --method kmer.")
    p.add_argument("--n-shuffles", type=int, default=1)
    p.add_argument("--num_tandem_repeats", "--tandem-repeats",
                   dest="tandem_repeats", type=int, default=0,
                   help="Generate n random tandem repeats.")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--itype", default=None, type=str.upper,
                   choices=["FASTA", "CSV"],
                   help="Input file type [default: inferred from "
                        "extension].")
    p.add_argument("--otype", "--output-format", dest="output_format",
                   default="csv", type=str.lower, choices=["csv", "fasta"])
    p.add_argument("--seq_col", "--seq-col", dest="seq_col", type=int,
                   default=None, help="CSV column holding the sequence.")
    p.add_argument("--class_col", "--class-col", dest="class_col", type=int,
                   default=None, help="CSV column holding the class id.")
    p.set_defaults(handler=ood_data, parser=p)

    for name in ("receptive-field", "receptive_field"):
        p = usub.add_parser(name, help="Static receptive field of a "
                                       "config's representation learner.")
        p.add_argument("-c", "--config", dest="config_path", required=True)
        p.set_defaults(handler=receptive_field, parser=p)

    p = usub.add_parser("dataset", help="Fragment + dedupe + split genomes "
                                        "into train/val/test sets.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--out-prefix", "--output", dest="out_prefix",
                   required=True)
    p.add_argument("--fraglen", "--frag-len", dest="frag_len", type=int,
                   default=2048, help="Max fragment length.")
    p.add_argument("--overlap", type=int, default=1024)
    p.add_argument("--trainperc", type=float, default=0.8)
    p.add_argument("--valperc", type=float, default=0.1)
    p.add_argument("--testperc", type=float, default=0.1)
    p.add_argument("--class", "--label", dest="label", type=int,
                   default=None, help="Class label (FASTA input).")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--intype", default=None, type=str.upper,
                   choices=["CSV", "FASTA"],
                   help="Input type [default: inferred from extension].")
    p.add_argument("--outtype", default="CSV", type=str.upper,
                   choices=["CSV", "FASTA"])
    p.add_argument("--seq_col", "--seq-col", dest="seq_col", type=int,
                   default=None,
                   help="CSV column holding the sequence (CSV input).")
    p.add_argument("--class_col", "--class-col", dest="class_col", type=int,
                   default=None,
                   help="CSV column holding the class id (CSV input; "
                        "overrides --class per row).")
    p.add_argument("--method", default="ANI", type=str.upper,
                   choices=["ANI", "AAI"],
                   help="Dereplication similarity: nucleotide (ANI) or "
                        "six-frame amino-acid (AAI) MinHash.")
    p.add_argument("--maxiden", "--dedupe-threshold",
                   dest="dedupe_threshold", type=float, default=0.6,
                   help="Max identity between any two kept fragments "
                        "(MinHash Jaccard threshold).")
    p.add_argument("--maxcov", type=float, default=0.6,
                   help="Max coverage between fragments.")
    p.add_argument("--dedupe", default="minhash",
                   choices=["minhash", "exact", "none"])
    p.add_argument("--mmseqs-bin", dest="mmseqs_bin", default=None,
                   help="Path/name of an mmseqs2 binary: dereplicate with "
                        "`easy-cluster --min-seq-id MAXIDEN -c MAXCOV` "
                        "instead of the in-repo MinHash.")
    p.set_defaults(handler=dataset, parser=p)

    p = usub.add_parser("convert-weights",
                        help="Convert reference checkpoints to jaeger-tpu "
                             "weights (no TensorFlow needed): legacy WRes "
                             "SavedModels or .h5 files, or modern-builder "
                             "Keras-3 .weights.h5 files plus their "
                             "project.yaml.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   help="TF SavedModel dir (wres) or Keras-3 .weights.h5 "
                        "(modern).")
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--family", default="wres", choices=["wres", "modern"])
    p.add_argument("-c", "--config", dest="config_path", default=None,
                   help="project.yaml / train config for --family modern.")
    p.add_argument("--num-res-blocks", type=int, default=5)
    p.set_defaults(handler=convert_weights, parser=p)
    p = usub.add_parser("convert-graph",
                        help="Export the forward pass as a portable "
                             "torch.export program (.pt2).")
    p.add_argument("-m", "--model", dest="model_path", required=True)
    p.add_argument("-o", "--output", dest="output_path", required=True)
    p.add_argument("--mode", default="xla",
                   choices=["xla", "tflite", "onnx", "tensorrt"],
                   help="Conversion mode; only the xla path exists here "
                        "(it writes a torch.export program).")
    p.add_argument("--int8", action="store_true",
                   help="Export from the int8-quantized weights (make the "
                        "bundle with 'utils quantize' first).")
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--precision", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.set_defaults(handler=convert_graph, parser=p)


def optimize_data(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.utils import optimize_data_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    if args.overlap is not None and not 0.0 <= args.overlap <= 1.0:
        parser.error(f"--overlap {args.overlap}: not in the range 0-1")
    summary = optimize_data_core(
        args.input_path, args.output_path, format=args.fmt,
        crop_size=list(args.crop_size or [500]), units=args.units,
        stride=args.stride, overlap=args.overlap, one_hot=args.one_hot,
        codon_map=args.codon_map, nucleotide_map=args.nucleotide_map,
        num_classes=args.num_classes, pad_int=args.pad_int,
        dtype=args.dtype, max_length=args.max_length,
        max_memory_mb=args.max_memory_mb, compress=args.compress,
        pad=args.pad, balance_classes=args.balance_classes,
        shuffle_seed=args.shuffle_seed, shard_size=args.shard_size,
        workers=args.workers,
    )
    print(summary)


def fragment(args: argparse.Namespace, parser) -> None:
    _existing(parser, args.input_path, "-i/--input", file_only=True)
    if args.minlen is not None or args.maxlen is not None:
        if args.minlen is None or args.maxlen is None:
            parser.error("--minlen and --maxlen must be given together")
        from jaeger_tpu_torch.dataops.split import split_core

        n = split_core(args.input_path, args.output_path,
                       minlen=args.minlen, maxlen=args.maxlen,
                       overlap=args.overlap, shuffle=args.shuffle)
        print(f"{n} fragments written to {args.output_path}")
        return
    from jaeger_tpu_torch.commands.utils import fragment_core

    n = fragment_core(args.input_path, args.output_path, fsize=args.fsize,
                      stride=args.stride, min_len=args.min_len,
                      label=args.label)
    print(f"{n} fragments written to {args.output_path}")


def mask_tandem(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.seqops.tandem import mask_fasta

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    kwargs = {}
    if args.minscore is not None:
        kwargs["minscore"] = args.minscore
    if args.maxperiod is not None:
        kwargs["maxperiod"] = args.maxperiod
    n = mask_fasta(args.input_path, args.output_path, workers=args.workers,
                   **kwargs)
    print(f"{n} bases masked -> {args.output_path}")


def mask(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.utils import mask_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    n = mask_core(args.input_path, args.output_path, minperc=args.minperc,
                  maxperc=args.maxperc, step=args.step, mutate=args.mutate,
                  seed=args.seed)
    print(f"{n} entries written to {args.output_path}")


def convert(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.utils import convert_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    n = convert_core(args.input_path, args.output_path, args.itype)
    print(f"{n} records converted")


def stats(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.utils import stats_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    summary = stats_core(args.input_path, output=args.output_dir)
    print(json.dumps(summary, indent=2, default=str))


def split(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.dataops.split import split_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    n = split_core(args.input_path, args.output_path, minlen=args.minlen,
                   maxlen=args.maxlen, overlap=args.overlap,
                   coverage=args.coverage, circular=args.circular,
                   max_n_prop=args.max_n_prop, seed=args.seed,
                   shuffle=args.shuffle)
    print(f"{n} fragments written to {args.output_path}")


def ood_data(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.dataops.ood import shuffle_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    _existing(parser, args.input_predictions, "-ip/--input_predictions")
    if (args.itype or "").upper() == "CSV" and args.seq_col is None:
        parser.error("when --itype CSV is used, --seq_col must be provided")
    method = "dinuc" if args.dinuc_flag else args.method
    summary = shuffle_core(
        args.input_path, args.output_path, method=method, kmer=args.kmer,
        n_shuffles=args.n_shuffles, tandem_repeats=args.tandem_repeats,
        seed=args.seed, output_format=args.output_format,
        seq_col=(1 if args.seq_col is None else args.seq_col),
        class_col=args.class_col, input_predictions=args.input_predictions)
    print(summary)


def receptive_field(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.utils.config import load_model_config
    from jaeger_tpu_torch.utils.receptive_field import (
        receptive_field_summary)

    _existing(parser, args.config_path, "-c/--config")
    cfg = load_model_config(args.config_path)
    model_cfg = cfg.get("model", cfg)
    rep = model_cfg.get("representation_learner", {})
    layers = rep.get("hidden_layers", [])
    if "branch" in rep:
        layers = rep["branch"].get("hidden_layers", [])
    sp = model_cfg.get("string_processor", {})
    crop = sp.get("crop_size") or (max(sp.get("crop_sizes", [0])) or None)
    print(receptive_field_summary(layers, crop_size=crop))


def dataset(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.utils import dataset_core

    _existing(parser, args.input_path, "-i/--input", file_only=True)
    if (args.intype or "").upper() == "CSV" and (args.seq_col is None
                                                 or args.class_col is None):
        parser.error("for CSV input, specify both --seq_col and --class_col")
    if (args.intype or "").upper() == "FASTA" and args.label is None:
        parser.error("for FASTA input, specify --class")
    summary = dataset_core(
        args.input_path, args.out_prefix, frag_len=args.frag_len,
        overlap=args.overlap, trainperc=args.trainperc,
        valperc=args.valperc, testperc=args.testperc,
        label=(0 if args.label is None else args.label), seed=args.seed,
        seq_col=args.seq_col, class_col=args.class_col,
        dedupe=(False if args.dedupe == "none" else args.dedupe),
        dedupe_threshold=args.dedupe_threshold, method=args.method,
        mmseqs_bin=args.mmseqs_bin, maxcov=args.maxcov,
        outtype=args.outtype)
    print(summary)


def convert_weights(args: argparse.Namespace, parser) -> None:
    """JAX's ``utils convert-weights`` (`jaeger_tpu/cli.py:889-946`): the
    same options, messages and files."""
    _existing(parser, args.input_path, "-i/--input")
    _existing(parser, args.config_path, "-c/--config")
    out = Path(args.output_path)
    if args.family == "modern":
        if args.config_path is None:
            parser.error("--family modern needs -c/--config (the "
                         "project.yaml saved next to the weights)")
        from jaeger_tpu_torch.models.artifacts import save_model
        from jaeger_tpu_torch.models.modern_convert import (
            convert_modern_weights)
        from jaeger_tpu_torch.utils.config import load_model_config

        config = load_model_config(args.config_path)
        variables = convert_modern_weights(config, args.input_path)
        save_model(variables, config, out)
        print(f"converted modern bundle written to {out}")
        return

    from jaeger_tpu_torch.models.artifacts import write_flax_msgpack
    from jaeger_tpu_torch.models.legacy_convert import (
        convert_wres_checkpoint, convert_wres_h5)

    if Path(args.input_path).is_file():
        if not str(args.input_path).endswith(".h5"):
            parser.error(f"{args.input_path}: expected a SavedModel "
                         f"directory or a .h5 weights file")
        variables = convert_wres_h5(args.input_path,
                                    num_res_blocks=args.num_res_blocks)
    else:
        variables = convert_wres_checkpoint(
            args.input_path, num_res_blocks=args.num_res_blocks)
    out.mkdir(parents=True, exist_ok=True)
    write_flax_msgpack(variables, out / "params.msgpack")
    (out / "legacy.yaml").write_text(
        "family: wres\nnum_res_blocks: %d\nsource: %s\n"
        % (args.num_res_blocks, args.input_path))
    print(f"converted weights written to {out}")


def convert_graph(args: argparse.Namespace, parser) -> None:
    """JAX's ``utils convert-graph`` (`jaeger_tpu/cli.py:973-1006`): the
    xla mode writes a ``torch.export`` program where JAX writes
    StableHLO; every other mode is refused with JAX's message."""
    _existing(parser, args.model_path, "-m/--model")
    if args.mode != "xla":
        parser.error(
            f"--mode {args.mode}: the TFLite/ONNX/TensorRT engine zoo is "
            "replaced by the single XLA path (see docs/optimizations.md); "
            "use --mode xla.")
    import torch

    from jaeger_tpu_torch.commands.predict import resolve_int8_bundle
    from jaeger_tpu_torch.models.conversion import export_graph

    model_path = args.model_path
    if args.int8:
        try:
            model_path = resolve_int8_bundle(model_path)
        except FileNotFoundError as e:
            parser.error(str(e))
    dtype = torch.bfloat16 if args.precision == "bfloat16" else torch.float32
    out = export_graph(model_path, args.output_path, batch=args.batch,
                       dtype=dtype)
    print(f"torch.export program written to {out}")


# --- health, taxonomy, the model registry -----------------------------------

def _health_parser(sub) -> None:
    p = sub.add_parser("health", help="Install self-test: the device, the "
                                      "encode path, a tiny model round "
                                      "trip.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device checks (default cuda; "
                        "'cpu' runs them on the CPU).")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.set_defaults(handler=health, parser=p)


def health(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.health import health_core

    sys.exit(health_core(device=args.device))


def _taxonomy_parsers(sub) -> None:
    p = sub.add_parser("taxonomy", help="Experimental embedding-based "
                                        "taxonomy assignment.")
    tsub = p.add_subparsers(dest="taxonomy_command", required=True)
    for name in ("build", "predict"):
        t = tsub.add_parser(
            name, help=("Build a cosine taxonomy index from reference "
                        "genomes." if name == "build" else
                        "Assign lineages to contigs via embedding k-NN + "
                        "majority LCA."))
        t.add_argument("-m", "--model", dest="model_path", required=True)
        t.add_argument("--model_path", dest="model_path_override",
                       default=None,
                       help="Path to a model bundle; overrides --model.")
        t.add_argument("--config", dest="registry_config", default=None,
                       help="Model-registry config file (accepted for "
                            "compatibility).")
        if name == "build":
            t.add_argument("-i", "--input", dest="fasta", required=True)
            t.add_argument("-a", "--acc2tax", "--acc2taxid",
                           dest="acc2taxid", required=True,
                           help="2-column TSV: accession -> taxid.")
            t.add_argument("-t", "--tax", "--taxdump", dest="taxdump_dir",
                           required=True,
                           help="NCBI taxdump directory (nodes.dmp/"
                                "names.dmp).")
            t.add_argument("-o", "--output", dest="out_dir", required=True)
        else:
            t.add_argument("-d", "--db", dest="db_dir", required=True)
            t.add_argument("-i", "--input", dest="fasta", required=True)
            t.add_argument("-o", "--output", dest="output", required=True)
            t.add_argument("-k", type=int, default=5)
            t.add_argument("--fraction", type=float, default=0.6)
        t.add_argument("--fsize", type=int, default=2000)
        t.add_argument("--stride", type=int, default=None,
                       help="Window stride [default: fsize].")
        t.add_argument("--batch", type=int, default=256)
        t.add_argument("--precision", default="bfloat16",
                       choices=["bfloat16", "float32", "bf16", "fp32",
                                "fp16", "float16"])
        t.add_argument("--rc", dest="reliability_cutoff", type=float,
                       default=0.1,
                       help="Accepted for compatibility (unused by the "
                            "taxonomy pipeline).")
        t.add_argument("--workers", type=int, default=4)
        _add_device_flags(t)
        t.add_argument("-f", "--overwrite", action="store_true")
        t.add_argument("-v", "--verbose", action="count", default=0)
        t.set_defaults(handler=taxonomy_build if name == "build"
                       else taxonomy_predict, parser=t)


def taxonomy_build(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.taxonomy import build_taxdb

    for path, flag in ((args.model_path, "-m/--model"),
                       (args.model_path_override, "--model_path"),
                       (args.registry_config, "--config"),
                       (args.fasta, "-i/--input"),
                       (args.acc2taxid, "-a/--acc2tax"),
                       (args.taxdump_dir, "-t/--tax")):
        _existing(parser, path, flag)
    device = _device_from_flags(args, parser)
    out = build_taxdb(args.model_path_override or args.model_path,
                      args.fasta, args.acc2taxid, args.taxdump_dir,
                      args.out_dir, fsize=args.fsize, stride=args.stride,
                      batch=args.batch, precision=args.precision,
                      workers=args.workers, overwrite=args.overwrite,
                      device=device)
    print(f"taxonomy db written to {out}")


def taxonomy_predict(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.commands.taxonomy import predict_taxonomy

    for path, flag in ((args.model_path, "-m/--model"),
                       (args.model_path_override, "--model_path"),
                       (args.registry_config, "--config"),
                       (args.db_dir, "-d/--db"), (args.fasta, "-i/--input")):
        _existing(parser, path, flag)
    device = _device_from_flags(args, parser)
    out = predict_taxonomy(args.model_path_override or args.model_path,
                           args.db_dir, args.fasta, args.output, k=args.k,
                           fraction=args.fraction, fsize=args.fsize,
                           stride=args.stride, batch=args.batch,
                           precision=args.precision, workers=args.workers,
                           overwrite=args.overwrite, device=device)
    print(f"taxonomy predictions written to {out}")


def _registry_parsers(sub) -> None:
    p = sub.add_parser("register-models", help="Register a local model "
                                               "bundle in the model "
                                               "registry.")
    p.add_argument("model_path_arg", nargs="?", default=None)
    p.add_argument("-p", "--path", dest="path_opt", default=None,
                   help="Path to model weights and configuration files.")
    p.add_argument("-c", "--config", "--registry", dest="registry",
                   default=None,
                   help="Registry config file to update (container use).")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.set_defaults(handler=register_models, parser=p)

    p = sub.add_parser("list-models", help="List registered model "
                                           "bundles.")
    p.add_argument("-c", "--config", "--registry", dest="registry",
                   default=None, help="Registry config file to read.")
    p.set_defaults(handler=list_models, parser=p)

    p = sub.add_parser("download", help="Download and register a model "
                                        "archive (requires network "
                                        "access).")
    p.add_argument("url", nargs="?", default=None)
    p.add_argument("-p", "--path", "-d", "--dest", dest="dest", default=None,
                   help="Directory to save model weights and configuration "
                        "files [default: models].")
    p.add_argument("-m", "--model_name", dest="model_name", default=None,
                   help="Identifier of a catalog model to download.")
    p.add_argument("-c", "--config", "--registry", dest="registry",
                   default=None,
                   help="Registry config file to update (container use).")
    p.add_argument("-l", "--list", dest="list_catalog", action="store_true",
                   help="List downloadable models from the published "
                        "catalog.")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.set_defaults(handler=download, parser=p)


def register_models(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.utils.registry import add_to_registry

    _existing(parser, args.model_path_arg, "MODEL_PATH_ARG")
    if args.path_opt is not None:
        _existing(parser, args.path_opt, "-p/--path")
        if not Path(args.path_opt).is_dir():
            parser.error(f"-p/--path: {args.path_opt!r} is a file")
    model_path = args.path_opt or args.model_path_arg
    if not model_path:
        parser.error("provide a model path (-p/--path)")
    data = add_to_registry(model_path, args.registry)
    print(f"registered; {len(data['model_paths'])} model path(s) known")


def list_models(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.utils.registry import AvailableModels

    models = AvailableModels(registry_path=args.registry)
    if not models.info:
        print("no models registered")
    for name, info in sorted(models.info.items()):
        print(f"{name}\t{info['path']}")


def download(args: argparse.Namespace, parser) -> None:
    from jaeger_tpu_torch.utils import registry

    url, dest = args.url, args.dest
    if args.list_catalog and (args.model_name or url):
        parser.error("the '--list' option cannot be used with a model or "
                     "URL")
    if args.list_catalog:
        try:
            for name, link in sorted(registry.list_model_catalog().items()):
                print(f"- {name}\t{link}")
        except (ConnectionError, ValueError) as e:
            raise CommandError(str(e)) from e
        return
    if args.model_name:
        try:
            links = registry.list_model_catalog()
        except (ConnectionError, ValueError) as e:
            raise CommandError(str(e)) from e
        if args.model_name not in links:
            parser.error(f"model '{args.model_name}' not found; use "
                         f"'--list' to see available models")
        url = links[args.model_name]
        # avoid scanning large user directories for models
        dest = str(Path(dest or "models") / "jaeger_models")
    if not url:
        parser.error("provide a URL or -m MODEL_NAME, or --list for the "
                     "catalog")
    try:
        registered = registry.download_models(url, dest or "models",
                                              args.registry)
        print(f"registered {len(registered)} model(s)")
    except OSError as e:
        raise CommandError(
            f"download failed ({e}); in sealed environments place the "
            "bundle locally and use `register-models` instead") from e


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="jaeger-tpu-torch",
        description="jaeger_tpu_torch: phage detection on NVIDIA GPUs.")
    sub = parser.add_subparsers(dest="command", required=True)
    _predict_parser(sub)
    _predict_legacy_parser(sub)
    _train_parser(sub)
    _health_parser(sub)
    _taxonomy_parsers(sub)
    _registry_parsers(sub)
    _utils_parser(sub)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=(logging.DEBUG if getattr(args, "verbose", 0) >= 2
               else logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    try:
        args.handler(args, args.parser)
    except CommandError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    sys.exit(main())
