"""One run of one cell: the contract's command line, the card check, the
driver, the import check, the metrics and the result line.

Standard output carries a ``counters`` line (the program's own counts:
forwards or steps by program, launches by route, kernel build seconds)
and, last, the result as one JSON object. Standard error ends with one
line for each number compared, beside its limit. A run that finds no
card, fewer cards than the cell asks for, no program beside it, or a
module of JAX or the JAX package loaded once the window has closed, exits
with a code other than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

from benchmark.harness.cell import ROOT, load_cell

#: top-level module names that no run may load (compared whole: the port,
#: ``jaeger_tpu_torch``, begins with ``jaeger_tpu``)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "jaeger_tpu"})
#: the program under test, a package of the checkout
PROGRAM = "jaeger_tpu_torch"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout. The
    port's own CUDA and host libraries go to ``build/jaeger_tpu_torch/``
    (``ops/cuda_build.py``, ``native/__init__.py``)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def counters() -> dict:
    """The program's own counters (read after the run)."""
    from jaeger_tpu_torch.ops import cuda_build, fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    return {"route_launches": dict(fused_conv.route_launches),
            "wgrad_route_launches": dict(fg.wgrad_route_launches),
            "launches": dict(fg.launches, fused_conv_block=fused_conv.launches),
            "build_seconds": dict(cuda_build.build_seconds)}


def per_layer(cell, context: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(context)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple[dict, list, dict]:
    """Drive one run of ``cell`` on ``device`` (the card check is the
    caller's). Returns (result, [(number, value, limit)], counters)."""
    import torch

    torch.set_num_threads(int(cell.settings["torch_threads"]))
    with tempfile.TemporaryDirectory(prefix="bench-") as work:
        out = cell.driver().run(cell, seed, seconds, trace, device, Path(work),
                                t_start)
    from benchmark.reference.judge import verdict

    correct, rows = verdict(out["numbers"], cell.limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": sum(v > lim for _, v, lim in rows)}
    breakdown = None
    if trace:
        summary = out["context"]["trace"]
        if summary is None:
            raise RuntimeError("the window ended before the traced range")
        metrics = per_layer(cell, out["context"])
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": summary.top_ops(), "idle_gaps": summary.top_gaps()}
    else:
        metrics = {}
        for m in cell.end_to_end:
            value = out["setup_s"] if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows, {**out["counters"], "numbers": out["numbers"]}


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not (ROOT / PROGRAM).is_dir():
        print(f"no {PROGRAM}/ beside BENCHMARK.json: nothing to measure",
              file=sys.stderr)
        return 5
    set_cache_dirs()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, rows, own = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print("counters " + json.dumps({**own, **counters()}, default=str))
    for k, v, lim in rows:
        print(f"check {k}: {v!r} (limit {lim!r})"
              f"{'' if v <= lim else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
