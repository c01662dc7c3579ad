#!/usr/bin/env python3
"""Smoke run of jaeger_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout on a machine with CUDA:

    python3 chip_smoke.py            # every phase; exits 0 when all pass
    python3 chip_smoke.py --quick    # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --profile  # also: device time by kernel (torch
                                     # profiler) of each flagship forward

Phases, each of which fails the run:

1. device: torch version, the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/fused_conv_block.cu for sm_90a;
3. kernel against its plain version on the card: the Pallas kernel's test
   cases, each extension, the demo and flagship shapes (2e-4 in f32,
   5e-2 in bf16); kernel, plain and library (F.conv1d + the same epilogue)
   times at the flagship shape (batch 2048: N = 12288, L = 500, C = 128,
   k = 5), with CUDA events;
4. the flagship (128 channels, 1505 nt crop, 6 classes; seeded weights,
   bf16) through the port's InferenceEngine at batch 2048, on windows
   that select the dense, the bounded-cut and the split (dense + masked
   bucket) programs: six kernel launches per forward, the forward
   matching the same forward on the plain conv block (5e-2), windows/s
   of the engine and of the forward alone, and the host's planning time;
5. the main path: the port's ``predict`` CLI with the flagship bundle and
   with the bundled demo model on jaeger_tpu/data/test/test_contigs.fasta
   (kernel launch counts reset just before, read just after); the TSV
   rows are checked, and the demo's against a CPU float32 run.

The second-to-last line is the kernels JSON, the last ``{"ok": true, ...}``.
The script imports nothing of JAX or of jaeger_tpu.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"

F32_TOL = 2e-4
BF16_TOL = 5e-2
#: the H100 SXM's dense bf16 tensor-core peak and HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 1 ---------------------------------------------------------------

def phase_device() -> str:
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


# --- phase 2 ---------------------------------------------------------------

def phase_build() -> None:
    from jaeger_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.load("fused_conv_block", extra_flags=("-Xptxas", "-v"))
    print(f"build: fused_conv_block ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda_build.build_seconds.get('fused_conv_block', 0.0):.1f} s)")


# --- phase 3 ---------------------------------------------------------------

def _conv_inputs(gen, n, length, c, k, dtype, device):
    import torch

    x = torch.randn(n, length, c, generator=gen).to(device, dtype)
    w = (torch.randn(k, c, c, generator=gen) * 0.05).to(device)
    bias = torch.randn(c, generator=gen).to(device)
    dyt = torch.stack([torch.full((c,), 0.5), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(device)
    return x, w, bias, dyt


def _extension_args(gen, x, case, device):
    """Keyword arguments of one extension case for (x: (N, L, C))."""
    import torch

    n, length, c = x.shape
    kw = {}
    if case in ("bias_then_dyt", "in_mask", "out_mask", "residual", "all",
                "model"):
        kw.update(use_dyt=True, bias_then_dyt=True)
    if case in ("in_mask", "all", "model"):
        kw["in_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if case in ("out_mask", "all", "model"):
        kw["out_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if case in ("residual", "all", "model"):
        kw["residual"] = torch.randn(n, length, c, generator=gen).to(
            device, x.dtype)
    return kw


def library_conv_block(x, w, bias, dyt, act, residual=None):
    """Yardstick only: cuDNN's conv plus the same epilogue in torch ops."""
    import torch
    import torch.nn.functional as F

    k = w.shape[0]
    pad_l = (k - 1) // 2
    y = F.conv1d(F.pad(x.transpose(1, 2), (pad_l, k - 1 - pad_l)),
                 w.to(x.dtype).permute(2, 1, 0), bias.to(x.dtype))
    y = y.transpose(1, 2)
    y = torch.tanh(y * dyt[0].to(x.dtype)) * dyt[1].to(x.dtype) + dyt[2].to(
        x.dtype)
    if residual is not None:
        y = y + residual
    return F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")


def phase_kernel() -> dict:
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, n, length, c, k, dtype, act, extension case)
    cases = [
        ("pallas_bias_k3", 8, 300, 128, 3, f32, "none", "bias"),
        ("pallas_bias_k5", 8, 300, 128, 5, f32, "none", "bias"),
        ("pallas_bias_k7", 8, 300, 128, 7, f32, "none", "bias"),
        ("pallas_dyt_gelu", 8, 256, 128, 5, f32, "gelu", "dyt"),
        ("pallas_ragged_relu", 10, 333, 128, 5, f32, "relu", "bias"),
        ("pallas_bf16", 8, 256, 128, 5, bf16, "none", "bias"),
    ]
    for dt, act in ((f32, "gelu"), (bf16, "gelu_tanh")):
        for ext in ("bias_then_dyt", "in_mask", "out_mask", "residual",
                    "all"):
            cases.append((f"{ext}_{str(dt)[6:]}", 6, 300, 128, 5, dt, act,
                          ext))
    cases += [
        ("demo_shape_bf16", 96 * 6, 165, 32, 3, bf16, "none", "in_mask"),
        ("flagship_shape_bf16", 6 * 256, 500, 128, 5, bf16, "gelu_tanh",
         "model"),
        ("flagship_shape_f32", 6 * 32, 500, 128, 5, f32, "gelu", "model"),
    ]
    worst = 0.0
    for name, n, length, c, k, dt, act, ext in cases:
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, dt, dev)
        if ext == "bias":
            kw = dict(bias=bias)
        elif ext == "dyt":
            kw = dict(bias=bias, dyt=dyt, use_dyt=True)
        elif ext == "in_mask" and dt == bf16 and c == 32:
            kw = dict(bias=bias, in_mask=(torch.rand(n, length, generator=gen)
                                          > 0.1).to(dev))
        else:
            kw = dict(bias=bias, dyt=dyt, **_extension_args(gen, x, ext, dev))
        before = fused_conv.launches
        out = fused_conv.fused_conv_block(x, w, act=act, **kw)
        torch.cuda.synchronize()
        check(fused_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
        check(out.dtype == x.dtype and out.shape == x.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"kernel {name}: max_abs_err {max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"{name}: {bad} elements beyond tolerance")
        if "out_mask" in kw and "residual" not in kw:
            check(bool((out[~kw["out_mask"]] == 0).all()),
                  f"{name}: out_mask positions not zero")
        if name == "flagship_shape_bf16":
            worst = max_err
        del x, w, out, ref, err

    # timings at the flagship batch: N = 6 * 2048 rows of 500 positions
    n, length, c, k = 6 * 2048, 500, 128, 5
    x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, bf16, dev)
    res = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    forms = {
        # conv1 of a residual block in the dense program
        "conv1": dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True),
        # conv2: the shortcut add rides the epilogue
        "conv2": dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True,
                      residual=res),
    }
    times = {}
    launches_before = fused_conv.launches
    for form, kw in forms.items():
        kern = cuda_ms(lambda: fused_conv.fused_conv_block(
            x, w, act="gelu_tanh", **kw))
        plain = cuda_ms(lambda: fused_conv.reference_conv_block(
            x, w, act="gelu_tanh", **kw), iters=3, warmup=1)
        lib = cuda_ms(lambda: library_conv_block(
            x, w, bias, dyt, "gelu_tanh", kw.get("residual")))
        flops = 2.0 * n * length * c * c * k
        nbytes = (2 * n * length * c * (3 if "residual" in kw else 2)
                  + 2 * k * c * c + 4 * 4 * c)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        times[form] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                           bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes", flops=flops, bytes=nbytes)
        print(f"timing {form} N={n} L={length} C={c} k={k} bf16: kernel "
              f"{kern:.3f} ms, plain {plain:.3f} ms, library {lib:.3f} ms, "
              f"bound {max(t_ops, t_bytes):.3f} ms "
              f"({times[form]['bound_by']}: {flops:.3e} FLOP, "
              f"{nbytes / 1e9:.3f} GB), {flops / kern / 1e9:.1f} TFLOP/s")
    fused_conv.launches = launches_before  # timing launches are not the path
    return {"max_abs_err": worst, **times["conv1"], "conv2": times["conv2"]}


# --- phase 4 ---------------------------------------------------------------

@contextlib.contextmanager
def plain_conv_block():
    """Run the model's residual convs on the plain version instead."""
    from jaeger_tpu_torch.models import layers
    from jaeger_tpu_torch.ops import fused_conv

    saved = layers.fused_conv_block
    layers.fused_conv_block = fused_conv.reference_conv_block
    try:
        yield
    finally:
        layers.fused_conv_block = saved


def _windows(rng, kind: str, n: int, crop: int):
    import numpy as np

    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.full(n, crop, np.int32)
    if kind == "bounded":
        # one interior N in every row: a 1-codon invalid run, cleared by
        # the first residual block (too many rows for the split bucket)
        cols = rng.integers(30, crop - 30, size=n)
        bases[np.arange(n), cols] = 4
    elif kind == "split":
        # 100 rows (<= bs/16) with long N runs or short lengths
        for i in range(0, 100):
            if i % 2:
                bases[i, 200:400] = 4
            else:
                lengths[i] = 900
                bases[i, 900:] = 4
    return bases, lengths


def print_device_profile(fn, label: str, top: int = 8) -> None:
    """Device time by kernel name over one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                    reverse=True)
    total = sum(e.self_device_time_total for e in events)
    print(f"profile {label}: {total / 1e3:.2f} ms device time in "
          f"{sum(e.count for e in events)} kernels")
    for e in events[:top]:
        share = e.self_device_time_total / max(total, 1e-9)
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {share:6.1%} "
              f"x{e.count:<4d} {e.key[:100]}")


def phase_flagship(profile: bool = False) -> dict:
    import numpy as np
    import torch

    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.models.flagship import flagship_config
    from jaeger_tpu_torch.ops import fused_conv

    bs = 2048
    cfg = flagship_config()
    model = build_model(cfg, dtype=torch.bfloat16)
    load_state(model, init_params(cfg, torch.Generator().manual_seed(42)))
    eng = InferenceEngine(model, batch_size=bs, device="cuda")
    crop = model.crop_nt
    rng = np.random.default_rng(7)
    expect = {"dense": {(bs, "dense")}, "bounded": None,
              "split": {(bs, "dense"), (bs // 16, "masked")}}
    rates = {}
    for kind in ("dense", "bounded", "split"):
        bases, lengths = _windows(rng, kind, bs, crop)
        t0 = time.perf_counter()
        dense, split, cut = eng._plan_batch(bases, lengths, bs)
        plan_ms = (time.perf_counter() - t0) * 1e3
        eng.program_counts.clear()
        before = fused_conv.launches
        out = eng.predict_windows(bases, lengths)
        torch.cuda.synchronize()
        forwards = sum(eng.program_counts.values())
        ran = set(eng.program_counts)
        if kind == "bounded":
            check(cut is not None and split is None and not dense,
                  f"bounded windows planned as {(dense, split, cut)}")
            expect["bounded"] = {(bs, ("bounded", cut))}
        check(ran == expect[kind], f"{kind}: programs {ran}")
        added = fused_conv.launches - before
        check(added == 6 * forwards,
              f"{kind}: {added} kernel launches for {forwards} forwards")
        for k, v in out.items():
            check(bool(np.isfinite(v).all()) and v.shape[0] == bs,
                  f"{kind}: output {k} {v.shape} not finite")
        # the same forward on the plain conv block, on the card
        tb = torch.from_numpy(bases).cuda()
        tl = torch.from_numpy(lengths).cuda()
        prog = dict(assume_dense=dense, mask_layers=None if dense else cut)
        if split is not None:
            prog = dict(assume_dense=False, mask_layers=None)
        with torch.inference_mode():
            a = model(tb, tl, **prog)
            with plain_conv_block():
                b = model(tb, tl, **prog)
        errs = {k: (a[k].float() - b[k].float()).abs().max().item()
                for k in a}
        for k in a:
            scale = b[k].float().abs().max().item()
            check(errs[k] <= BF16_TOL * max(scale, 1e-3),
                  f"{kind}: {k} kernel vs plain {errs[k]:.3e} "
                  f"(scale {scale:.3e})")
        # windows/s: the engine (host planning, packing, copies) and the
        # model forward alone
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.predict_windows(bases, lengths)
        torch.cuda.synchronize()
        eng_rate = reps * bs / (time.perf_counter() - t0)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(tb, tl, **prog), iters=5)
            if profile:
                print_device_profile(lambda: model(tb, tl, **prog),
                                     f"flagship {kind} forward")
        rates[kind] = dict(engine_windows_per_s=eng_rate,
                           forward_ms=fwd_ms,
                           forward_windows_per_s=bs / fwd_ms * 1e3,
                           host_plan_ms=plan_ms)
        print(f"flagship {kind}: programs {sorted(map(str, ran))}, "
              f"{added} launches / {forwards} forwards, kernel vs plain "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; engine {eng_rate:.0f} windows/s, forward "
              f"{fwd_ms:.2f} ms ({bs / fwd_ms * 1e3:.0f} windows/s), host "
              f"plan {plan_ms:.1f} ms")
        del tb, tl, a, b
    return rates


# --- phase 5 ---------------------------------------------------------------

def _read_tsv(path: Path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter="\t"))


def _check_tsv(rows: list[dict], labels: list[str], what: str) -> None:
    check(len(rows) == 9, f"{what}: {len(rows)} rows, expected 9")
    for r in rows:
        check(r["prediction"] in labels, f"{what}: label {r['prediction']}")
        for lab in labels:
            check(math.isfinite(float(r[f"{lab}_score"])),
                  f"{what}: {lab}_score not finite")


def phase_predict(tmp: Path) -> int:
    import torch

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import init_params, save_model
    from jaeger_tpu_torch.models.flagship import _CLASSES, flagship_config
    from jaeger_tpu_torch.ops import fused_conv

    cfg = flagship_config()
    bundle = save_model(init_params(cfg, torch.Generator().manual_seed(42)),
                        cfg, tmp / "flagship_bundle")
    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "flagship"),
              "-m", str(bundle), "--fsize", "1505", "--batch", "2048"])
    dt = time.perf_counter() - t0
    launches = fused_conv.launches
    check(launches > 0 and launches % 6 == 0,
          f"flagship predict: {launches} kernel launches")
    rows = _read_tsv(tmp / "flagship" / "test_contigs_default_jaeger.tsv")
    _check_tsv(rows, _CLASSES, "flagship predict")
    print(f"predict flagship (bf16, batch 2048): {len(rows)} contigs in "
          f"{dt:.2f} s, {launches} kernel launches")

    # the bundled demo model: GPU bf16, GPU f32 and CPU f32
    demo_labels = ["chromosome", "phage", "plasmid"]
    before = fused_conv.launches
    runs = {}
    for name, extra in (("gpu_bf16", []),
                        ("gpu_f32", ["--precision", "float32"]),
                        ("cpu_f32", ["--precision", "float32", "--device",
                                     "cpu"])):
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / name)]
                 + extra)
        runs[name] = _read_tsv(tmp / name / "test_contigs_default_jaeger.tsv")
        _check_tsv(runs[name], demo_labels, f"demo predict {name}")
    check(fused_conv.launches > before, "demo predict launched no kernel")
    ref = {r["contig_id"]: r for r in runs["cpu_f32"]}
    for name in ("gpu_f32", "gpu_bf16"):
        tol = 0.01 if name == "gpu_f32" else 0.15
        worst = 0.0
        for r in runs[name]:
            c = ref[r["contig_id"]]
            for lab in demo_labels:
                worst = max(worst, abs(float(r[f"{lab}_score"])
                                       - float(c[f"{lab}_score"])))
        check(worst <= tol, f"demo {name} vs cpu_f32: score diff {worst}")
        same = sum(r["prediction"] == ref[r["contig_id"]]["prediction"]
                   for r in runs[name])
        print(f"predict demo {name}: {len(runs[name])} contigs, max score "
              f"diff vs CPU f32 {worst:.3f} (tol {tol}), {same}/9 calls "
              f"equal")
    return launches


def main(argv: list[str]) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "jaeger_tpu_torch").is_dir() or not FASTA.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    quick = "--quick" in argv
    t_start = time.perf_counter()
    try:
        card = phase_device()
        phase_build()
        kern = phase_kernel()
        if quick:
            print(f"quick run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        rates = phase_flagship(profile="--profile" in argv)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            launches = phase_predict(Path(tmp))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"flagship_windows_per_s": rates, "card": card,
                      "fused_conv_conv2_form": kern["conv2"]}))
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_conv_block",
        "route": "cuda",
        "source": "jaeger_tpu_torch/csrc/fused_conv_block.cu",
        "replaces": "jaeger_tpu/ops/pallas_conv.py:70",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
