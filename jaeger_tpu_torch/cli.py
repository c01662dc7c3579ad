"""jaeger_tpu_torch command-line interface.

Counterpart of `jaeger_tpu/cli.py`: ``predict``, with the JAX command's
options for the one-device modern-model path (``--int8 [full|auto]`` and
``--quantized`` included) plus ``--device``, and ``utils quantize``.
Options of paths that are not ported yet (``--seq-shard``,
``--num-hosts``, ``--prophage``, ``--refine``, ``--mask-tandem``,
``--profile``) are accepted and refused with a clear error. Built on
``argparse`` so the CLI needs nothing beyond the standard library.

    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/
    python -m jaeger_tpu_torch.cli utils quantize -m model -o model_int8 \
        --mode full_int8
    python -m jaeger_tpu_torch.cli predict -i contigs.fasta -o out/ \
        -m model --int8 auto
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

logger = logging.getLogger("jaeger_tpu_torch")


def _predict_parser(sub) -> None:
    p = sub.add_parser("predict", help="Identify phage sequences in a FASTA "
                                       "of contigs.")
    p.add_argument("-i", "--input", dest="input_path", required=True)
    p.add_argument("-o", "--output", dest="output_dir", required=True)
    p.add_argument("-m", "--model", dest="model_path", default=None,
                   help="Model bundle directory (default: the bundled demo "
                        "model).")
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
    # later slices
    p.add_argument("--seq-shard", type=int, default=1)
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("-p", "--prophage", action="store_true")
    p.add_argument("--refine", action="store_true")
    p.add_argument("--mask-tandem", action="store_true")
    p.add_argument("--profile", action="store_true")


def predict(args: argparse.Namespace) -> None:
    from jaeger_tpu_torch.commands.predict import resolve_model_path, run_core

    crf_matrix = None
    if args.crf_transition_matrix:
        with open(args.crf_transition_matrix) as fh:
            crf_matrix = json.load(fh)
    table = run_core(
        input_path=args.input_path, output_dir=args.output_dir,
        model_path=resolve_model_path(args.model_path),
        fsize=args.fsize, stride=args.stride, batch=args.batch,
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
        refine=args.refine, mask_tandem=args.mask_tandem,
        profile=args.profile,
    )
    print(f"summary written to {table}")


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


def quantize(args: argparse.Namespace) -> None:
    from jaeger_tpu_torch.models.conversion import quantize_bundle

    print(quantize_bundle(args.model_path, args.output_path, mode=args.mode,
                          device=args.device))


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="jaeger-tpu-torch",
        description="jaeger_tpu_torch: phage detection on NVIDIA GPUs.")
    sub = parser.add_subparsers(dest="command", required=True)
    _predict_parser(sub)
    _utils_parser(sub)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 2 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.command == "utils":
        quantize(args)
    else:
        predict(args)


if __name__ == "__main__":
    sys.exit(main())
