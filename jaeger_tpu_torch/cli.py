"""jaeger_tpu_torch command-line interface.

Counterpart of `jaeger_tpu/cli.py`: ``predict``, with the JAX command's
options for the one-device modern-model path (``--int8 [full|auto]``,
``--quantized``, ``--prophage`` with ``-s/--sensitivity``, ``--lc`` and
``--plot-type``, ``--refine`` with the ``--refine-*`` options,
``--mask-tandem``, ``--profile``, ``--model_path`` and ``--getalllabels``
included) plus ``--device``; ``predict -m default|experimental[_N]``
(without ``--model_path``) runs the legacy workflow with ``predict``'s
defaults, as JAX's CLI does; ``predict-legacy`` (JAX's options, plus
``--device``); ``train`` (fragment models on one device, with
``--device``), ``utils quantize`` and ``utils combine-models`` (the JAX
command's options, plus ``--device``). Options of paths that are not
ported yet (``--seq-shard``, ``--num-hosts``) are accepted and refused
with a clear error. A usage error (``--int8`` without an int8 bundle)
exits 2 with its message, as click does. Built on ``argparse`` so the CLI
needs nothing beyond the standard library.

    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/ \
        -m default
    python -m jaeger_tpu_torch.cli predict-legacy -i contigs.fasta -o out/
    python -m jaeger_tpu_torch.cli utils quantize -m model -o model_int8 \
        --mode full_int8
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/ \
        -m model --int8 auto
    python -m jaeger_tpu_torch.cli train -c config.yaml -o model/
    python -m jaeger_tpu_torch.cli utils combine-models -i model_a \
        -i model_b -o ensemble -c mv
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

logger = logging.getLogger("jaeger_tpu_torch")

#: ``-m`` names that route ``predict`` to the legacy workflow
LEGACY_MODELS = ("default", "experimental", "experimental_1",
                 "experimental_2")


def _predict_parser(sub) -> argparse.ArgumentParser:
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the "
                        "CPU).")
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
    # later slices
    p.add_argument("--seq-shard", type=int, default=1)
    p.add_argument("--num-hosts", type=int, default=1)
    return p


def predict(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    from jaeger_tpu_torch.commands.predict import (resolve_int8_bundle,
                                                   resolve_model_path,
                                                   run_core)

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
            device=args.device)
        print(f"summary written to {table}")
        return
    model_path = (args.model_path_override
                  or resolve_model_path(args.model_path))
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
        precision=args.precision, device=args.device, workers=args.workers,
        crf_switch_cost=args.crf_switch_cost if args.crf else None,
        crf_prior=args.crf_prior, crf_transition_matrix=crf_matrix,
        reliability_cutoff=args.reliability_cutoff,
        phage_score=args.phage_score, scan_termini=not args.no_termini,
        save_window_scores=args.window_scores,
        getsequences=args.getsequences, save_embedding=args.save_embedding,
        save_nmd=args.save_nmd, overwrite=args.overwrite,
        int8=args.int8, quantized=args.quantized, seq_shard=args.seq_shard,
        num_hosts=args.num_hosts, prophage=args.prophage,
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


def predict_legacy(args: argparse.Namespace) -> None:
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
    # later slices
    p.add_argument("--self-supervised-pretraining",
                   "--self_supervised_pretraining",
                   dest="self_supervised_pretraining", action="store_true")
    p.add_argument("--generate-reliability-data",
                   "--generate_reliability_data",
                   dest="generate_reliability_data", action="store_true",
                   default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", "--num_processes",
                   dest="num_processes", type=int, default=None)
    p.add_argument("--process-id", "--process_id", dest="process_id",
                   type=int, default=None)


def train(args: argparse.Namespace) -> None:
    from jaeger_tpu_torch.commands.train import train_fragment_core

    if args.coordinator or (args.num_processes or 1) > 1:
        raise NotImplementedError(
            "multi-device training is not yet ported to jaeger_tpu_torch "
            "(ROADMAP.md queue 1, item 11)")
    results = train_fragment_core(
        config_path=args.config_path, output_dir=args.output_dir,
        epochs_override=args.epochs, steps_override=args.steps_per_epoch,
        self_supervised_pretraining=args.self_supervised_pretraining,
        generate_reliability=args.generate_reliability_data,
        from_last_checkpoint=args.from_last_checkpoint, force=args.force,
        ignore_convergence=args.ignore_convergence,
        only_classification_head=args.only_classification_head,
        only_reliability_head=args.only_reliability_head,
        only_save=args.only_save, masking=args.masking,
        precision=args.precision, meta=args.meta, device=args.device)
    print(f"model written to {results.get('model_path')}")


def _utils_parser(sub) -> None:
    p = sub.add_parser("utils", help="Model utilities.")
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


def quantize(args: argparse.Namespace) -> None:
    from jaeger_tpu_torch.models.conversion import quantize_bundle

    print(quantize_bundle(args.model_path, args.output_path, mode=args.mode,
                          device=args.device))


def combine_models(args: argparse.Namespace) -> None:
    from pathlib import Path

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


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="jaeger-tpu-torch",
        description="jaeger_tpu_torch: phage detection on NVIDIA GPUs.")
    sub = parser.add_subparsers(dest="command", required=True)
    predict_parser = _predict_parser(sub)
    _predict_legacy_parser(sub)
    _train_parser(sub)
    _utils_parser(sub)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 2 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.command == "utils":
        {"quantize": quantize,
         "combine-models": combine_models}[args.utils_command](args)
    elif args.command == "train":
        train(args)
    elif args.command == "predict-legacy":
        predict_legacy(args)
    else:
        predict(args, predict_parser)


if __name__ == "__main__":
    sys.exit(main())
