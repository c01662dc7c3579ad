#!/usr/bin/env python3
"""Smoke run of jaeger_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout on a machine with CUDA:

    python3 chip_smoke.py            # every phase; exits 0 when all pass
    python3 chip_smoke.py --quick    # phases 1-3b only (build, kernel checks)
    python3 chip_smoke.py --profile  # also: device time by kernel (torch
                                     # profiler) of each flagship forward
    python3 chip_smoke.py --sweep    # also: the kernels under other
                                     # launch plans and with fewer taps,
                                     # the backward wrappers' host time
    python3 chip_smoke.py --backward # phases 1, 2 and 3b only (the
                                     # backward kernels)
    python3 chip_smoke.py --host     # phases 1, 2 and 7 only (the host
                                     # pipeline and the predict stages)

Phases, each of which fails the run:

1. device: torch version, the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/fused_conv_block.cu, csrc/int8_conv.cu,
   csrc/fused_conv_wgrad.cu and csrc/conv_epilogue_bwd.cu for sm_90a, one
   nvcc per source, started together; ptxas' registers, stack and spills
   of each instance of the wgmma kernels, wgrad_f32 and conv_epilogue_bwd;
3. each kernel against its plain version on the card. fused_conv_block:
   the Pallas kernel's test cases, each extension, the demo and flagship
   shapes, and the bf16 kernel's edges (L = 1, 63, 65; N = 1; C = 16, 64,
   256; k = 1, 7; in_mask runs across tile edges and the halo; out_mask
   with residual; every activation) at 2e-4 in f32, 5e-2 in bf16; kernel,
   plain and library (F.conv1d + the same epilogue) times at the flagship
   shape (batch 2048: N = 12288, L = 500, C = 128, k = 5) in the conv1,
   conv2 and bias-only forms, each with its bound and share of it.
   int8_conv: the plan of the main path's shapes names the wgmma route;
   the requant form equal to its plain version at the Pallas parity case,
   the Pallas chip shape (N = 12288, L = 500, C = 128, k = 5, dilation 3)
   and the wgmma kernel's edges (L 1 / 63 / 65, N 1, C 32 / 64 / 256,
   C_in != C_out, k 1 / 3 / 7) and an mma-route shape; the dequant form at
   each extension, the demo and flagship shapes, dilation 3 in SAME and
   VALID, the same edges, in_mask runs across tile edges and the halo,
   out_mask with residual and every activation (2e-4 in f32, which takes
   the mma route, 5e-2 in bf16); kernel, plain and library (k
   ``torch._int_mm`` GEMMs on shifted copies + the epilogue in torch)
   times of the requant form at the Pallas shape and of the dequant form
   at the flagship shape (conv1, conv2 and bias-only forms). All times
   with CUDA events, each with its bound;
3b. the fused conv's backward: conv_wgrad (one tile first; L 1 / 63 / 64
   / 65 / 500, C 64 / 128 / 256, k 3 / 5, in_mask none, random and runs
   across tile edges and the halo), conv_epilogue_bwd (every activation
   with and without residual, out mask and DYT, f32 and bf16, C 16 / 48 /
   128 / 256, ragged row counts) and the flipped-weight data gradient
   against their plain versions at the train shape (N = 1536, L = 500, C =
   128, k = 5) in bf16 and at small shapes, both kernels the same bits run
   to run; bf16 outputs within 2 ulps + 1e-4 of the scale, f32 within 2e-4
   (conv_wgrad 1e-3 in bf16); FusedConvBlockFn's whole backward at the
   train shape within 2 ulps + 5e-3 of the scale; kernel, plain, library
   and bound times, and each kernel's host microseconds a call;
4. the flagship (128 channels, 1505 nt crop, 6 classes; seeded weights,
   bf16) through the port's InferenceEngine at batch 2048, on windows
   that select the dense, the bounded-cut and the split (dense + masked
   bucket) programs: six kernel launches per forward, the forward
   matching the same forward on the plain versions (5e-2), windows/s of
   the engine and of the forward alone, and the host's planning time.
   Then the same for the flagship's full_int8 bundle, calibrated on the
   card by the port's ``quantize_bundle``: six int8_conv launches and no
   fused_conv_block launch per forward;
5. the main path: the port's ``predict`` CLI with the flagship bundle and
   with the bundled demo model on jaeger_tpu/data/test/test_contigs.fasta,
   then ``predict --int8`` and ``--int8 auto`` with the flagship's int8
   bundle and with a demo int8 bundle made by ``utils quantize`` (kernel
   launch counts reset just before each, read just after); the TSV rows
   are checked, the demo's against a CPU float32 run (float and int8);
6. training: one f32 step of a narrow flagship template on the card
   against the CPU in each program (dense, bounded, masked);
   ``train_fragment_core`` with the flagship template at full width
   (batch 256, bf16) on synthetic CSVs from a seed, 30 classifier and 4
   reliability steps through all three programs (launch counts reset just
   before, read just after; losses finite and falling; 18 / 6 / 6
   launches per dense step); each program's steady-state step time and
   device time; then ``predict`` and ``predict --int8`` on the bundle and
   the int8 bundle it wrote;
7. host pipeline and full predict: the port's native host library must
   be live and its own (``build/jaeger_tpu_torch/libjaeger_host-*.so``);
   on a seeded synthetic assembly (750 contigs of 5-75 kb, 30 Mb, with
   N runs, low-complexity tracts and a tandem tract) the host windowing
   rate at 1, 4 and all workers (native) and on its first 25 contigs
   (pure Python, whose windows must equal the native ones); the
   terminal-repeat scan's seconds; ``predict`` with the flagship bundle
   (``--fsize 1505 --batch 2048``, default stages) end to end: wall
   seconds and windows/s (launch counts reset just before, read just
   after), the same with ``--no-termini``, the engine's host ms per batch
   for pack, upload and plan against the forward's ms, the card's busy
   share of the inference loop from a ``--profile`` run's trace, and a
   cProfile top 10 of the host in a ``--no-termini`` run;
   then ``--mask-tandem``, ``--prophage`` (its region equal to a CPU
   float32 run's), ``--refine`` (a seeded ``*_refine.yaml`` beside the
   bundle) and ``--profile`` on a small FASTA, each checked for its files
   and for fused_conv_block launches.

The second-to-last line is the kernels JSON, the last ``{"ok": true, ...}``.
The script imports nothing of JAX or of jaeger_tpu.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"

F32_TOL = 2e-4
BF16_TOL = 5e-2
#: the backward kernels in bf16 against their plain versions on the same
#: inputs, as (tol of the scale, bf16 ulps): both sum in f32 and round once,
#: so a bf16 output may land one ulp apart (2 allowed); the 1e-4 floor
#: covers f32 noise where the value is near zero (1 - t^2 at a saturated
#: tanh, act'(s) near its zero), and it bounds the f32 sums (dW, db, ddyt)
BF16_KERNEL_TOL = (1e-4, 2)
#: the whole backward: where the kernel's and the plain version's tanh
#: round du to neighbouring bf16 values, dW, db and dx move by x * ulp(du)
#: and w * ulp(du); 5e-3 of the scale holds that
BF16_BACKWARD_TOL = (5e-3, 2)
#: the H100 SXM's dense bf16 tensor-core peak and HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
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


def host_us(fn, calls: int = 100, repeats: int = 5) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls that do not
    wait for the card (the launch cost a step's host thread pays), starting
    on an idle card after a warm-up: the median of ``repeats`` such runs
    (the host clock of a shared machine spreads)."""
    import torch

    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


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

KERNEL_SOURCES = ("fused_conv_block", "int8_conv", "fused_conv_wgrad",
                  "conv_epilogue_bwd")


def phase_build() -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from jaeger_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(lambda name: cuda_build.load(
            name, extra_flags=("-Xptxas", "-v")), KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        print(f"build: {name} (nvcc "
              f"{cuda_build.build_seconds.get(name, 0.0):.1f} s)")
    print(f"build: all kernels ready in {time.perf_counter() - t0:.1f} s")
    for name, kernel in (("fused_conv_block", "conv_bf16_wgmma"),
                         ("int8_conv", "int8_wgmma"),
                         ("fused_conv_wgrad", "wgrad_bf16"),
                         ("fused_conv_wgrad", "wgrad_f32"),
                         ("conv_epilogue_bwd", "conv_epilogue_bwd")):
        for line in ptxas_summary(cuda_build.build_logs.get(name, ""), kernel):
            print(f"ptxas: {line}")


def ptxas_summary(log: str, kernel: str) -> list[str]:
    """Registers, shared memory and spills that ``-Xptxas -v`` reported for
    each instance of ``kernel`` (C++ name fragment) in ``log``."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            entry = name if kernel in name else None
        elif entry is not None and ("Used" in line or "spill" in line):
            out.append(f"{kernel}<{_template_args(entry.rsplit(kernel, 1)[1])}>"
                       f": {line.split(':', 1)[-1].strip()}")
    return out


def _template_args(mangled: str) -> str:
    """'bf16, 128, 64' from the Itanium mangling of a kernel's template
    arguments (``I13__nv_bfloat16Li128ELi64EEEv...``, ``IaLi16ELi32E...``,
    ``IfLi4ELb1EEEv...``: int and bool arguments)."""
    args = mangled.split("EEv", 1)[0] + "E"
    types = {"a": "int8", "13__nv_bfloat16": "bf16", "f": "f32"}
    m = re.match(r"I(a|f|13__nv_bfloat16)?", args)
    head = [types[m.group(1)]] if m and m.group(1) else []
    return ", ".join(head + re.findall(r"L[ib](\d+)E", args))


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
                "model", "in_mask_runs", "out_mask_residual"):
        kw.update(use_dyt=True, bias_then_dyt=True)
    if case in ("in_mask", "all", "model"):
        kw["in_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if case == "in_mask_runs":
        # masked runs across the 64-row tile edges and into the halo at
        # both ends of each row
        m = torch.ones(n, length, dtype=torch.bool)
        for lo, hi in ((0, 3), (60, 69), (125, 131), (length - 3, length)):
            m[:, max(lo, 0):min(hi, length)] = False
        kw["in_mask"] = m.to(device)
    if case in ("out_mask", "all", "model", "out_mask_residual"):
        kw["out_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if case in ("residual", "all", "model", "out_mask_residual"):
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
    if dyt is not None:
        y = torch.tanh(y * dyt[0].to(x.dtype)) * dyt[1].to(x.dtype) + dyt[
            2].to(x.dtype)
    if residual is not None:
        y = y + residual
    if act == "none":
        return y
    return F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")


def phase_kernel(card: str) -> dict:
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
        # the bf16 kernel's edges: 64-row tiles, the TMA halo, the plan's
        # chunk widths (C 16 / 32 / 64) and column blocks (CB < C at C 256
        # and at C 128 with k 7)
        ("edge_L1", 4, 1, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_L63", 3, 63, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_L65", 3, 65, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_N1", 1, 500, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_C16", 6, 300, 16, 3, bf16, "gelu_tanh", "all"),
        ("edge_C64_k3", 6, 300, 64, 3, bf16, "gelu_tanh", "model"),
        ("edge_C256_k5", 6, 300, 256, 5, bf16, "gelu_tanh", "model"),
        ("edge_C128_k7", 6, 300, 128, 7, bf16, "gelu_tanh", "model"),
        ("edge_k1", 6, 300, 128, 1, bf16, "gelu_tanh", "model"),
        ("edge_in_mask_runs", 6, 300, 128, 5, bf16, "gelu_tanh",
         "in_mask_runs"),
        ("edge_out_mask_residual", 6, 300, 128, 5, bf16, "gelu_tanh",
         "out_mask_residual"),
        ("edge_act_tanh", 6, 130, 128, 3, bf16, "tanh", "all"),
        ("edge_act_gelu_erf", 6, 130, 128, 3, bf16, "gelu", "all"),
        ("edge_act_relu", 6, 130, 128, 3, bf16, "relu", "bias"),
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
    dyt_kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True)
    forms = {
        # conv1 of a residual block in the dense program
        "conv1": (dyt_kw, "gelu_tanh"),
        # conv2: the shortcut add rides the epilogue
        "conv2": (dict(dyt_kw, residual=res), "gelu_tanh"),
        # the products and a bias add only: conv1 minus this is the cost of
        # the DYT + gelu_tanh epilogue
        "bias_only": (dict(bias=bias), "none"),
    }
    times = {}
    launches_before = fused_conv.launches
    for form, (kw, act) in forms.items():
        kern = cuda_ms(lambda: fused_conv.fused_conv_block(
            x, w, act=act, **kw), iters=20)
        plain = cuda_ms(lambda: fused_conv.reference_conv_block(
            x, w, act=act, **kw), iters=3, warmup=1)
        lib = cuda_ms(lambda: library_conv_block(
            x, w, bias, kw.get("dyt"), act, kw.get("residual")))
        flops = 2.0 * n * length * c * c * k
        nbytes = (2 * n * length * c * (3 if "residual" in kw else 2)
                  + 2 * k * c * c + 4 * c * (4 if "dyt" in kw else 1))
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        times[form] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, bound_share=bound / kern,
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes", flops=flops, bytes=nbytes)
        print(f"timing {form} N={n} L={length} C={c} k={k} bf16 on {card}: "
              f"kernel {kern:.3f} ms, plain {plain:.3f} ms, library "
              f"{lib:.3f} ms, bound {bound:.3f} ms "
              f"({times[form]['bound_by']}: {flops:.3e} FLOP, "
              f"{nbytes / 1e9:.3f} GB), {bound / kern:.1%} of the bound, "
              f"{flops / kern / 1e9:.1f} TFLOP/s")
    fused_conv.launches = launches_before  # timing launches are not the path
    return {"max_abs_err": worst, **times["conv1"], "conv2": times["conv2"],
            "bias_only": times["bias_only"]}


def phase_sweep(card: str) -> None:
    """``--sweep``: the bf16 kernel at the flagship shape (bias-only and
    conv1 forms) under other launch plans of the same layout (column block,
    ring stages) and with fewer taps (k = 1, 3: the same bytes, 1/5 and 3/5
    of the products), to tell the ring's latency from the tensor cores."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    n, length, c = 6 * 2048, 500, 128
    launches_before = fused_conv.launches
    for k in (5, 3, 1):
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, torch.bfloat16,
                                       dev)
        w = w.to(torch.bfloat16)  # _launch takes the checked operands
        plans = [fused_conv.conv_plan(c, k)]
        if k == 5:
            plans += [dict(cb=cb, kw=64, stages=st,
                           smem=fused_conv.plan_bytes(c, k, cb, 64, st))
                      for cb, st in ((128, 2), (64, 2), (64, 3), (64, 4),
                                     (32, 4))]
        for plan in plans:
            for form, args in (("bias_only", (bias, None, "none")),
                               ("conv1", (bias, dyt, "gelu_tanh"))):
                ms = cuda_ms(lambda: fused_conv._launch(
                    x, w, *args, None, None, None, plan), iters=20)
                bound = 2.0 * n * length * c * c * k / PEAK_BF16_FLOPS * 1e3
                print(f"sweep k={k} cb={plan['cb']} stages={plan['stages']} "
                      f"{form} on {card}: {ms:.3f} ms "
                      f"(products at the bf16 peak {bound:.3f} ms)")
        del x, w
    fused_conv.launches = launches_before


def shifted_copies(q, k: int, dilation: int):
    """(k, N * L, C): the SAME-padded int8 input (N, L, C) shifted by each
    tap, as contiguous copies."""
    import torch
    import torch.nn.functional as F

    n, length, c = q.shape
    span = dilation * (k - 1)
    qp = F.pad(q, (0, 0, span // 2, span - span // 2))
    return torch.stack([qp[:, j * dilation:j * dilation + length]
                        for j in range(k)]).view(k, n * length, c)


def library_int8_conv(shifted, w):
    """Yardstick only: k cuBLASLt int8 GEMMs (``torch._int_mm``) on
    shifted copies; int32 sums (N * L, C_out)."""
    import torch

    acc = None
    for j in range(w.shape[0]):
        y = torch._int_mm(shifted[j], w[j])
        acc = y if acc is None else acc.add_(y)
    return acc


def _int8_dequant_inputs(gen, n, length, c_in, c_out, k, dtype, device):
    """x, w (int8), inv_act, dq, bias, dyt with the calibrated scales'
    shapes: act_scale = absmax / 127, per-channel w_scale."""
    import torch

    x = torch.randn(n, length, c_in, generator=gen).to(device, dtype)
    w = torch.randint(-127, 128, (k, c_in, c_out), generator=gen,
                      dtype=torch.int8).to(device)
    act_scale = x.float().abs().max() / 127.0
    w_scale = (torch.rand(c_out, generator=gen) * 0.002 + 1e-4).to(device)
    dq = w_scale * act_scale
    inv_act = (1.0 / act_scale).reshape(1)
    bias = torch.randn(c_out, generator=gen).to(device)
    dyt = torch.stack([torch.full((c_out,), 0.5),
                       torch.randn(c_out, generator=gen),
                       torch.randn(c_out, generator=gen)]).to(device)
    return x, w, inv_act, dq, bias, dyt


def _int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt, device):
    """Keyword arguments of one int8 dequant extension case."""
    import torch

    kw = {}
    if ext in ("bias_then_dyt", "out_mask", "residual", "all", "model",
               "in_mask_runs", "out_mask_residual"):
        kw.update(dyt=dyt, use_dyt=True, bias_then_dyt=True)
    if ext in ("in_mask", "all", "model"):
        kw["in_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if ext == "in_mask_runs":
        # masked runs across the 64-row tile edges and into the halo at
        # both ends of each row
        m = torch.ones(n, length, dtype=torch.bool)
        for lo, hi in ((0, 3), (60, 69), (125, 131), (length - 3, length)):
            m[:, max(lo, 0):min(hi, length)] = False
        kw["in_mask"] = m.to(device)
    if ext in ("out_mask", "all", "model", "out_mask_residual"):
        kw["out_mask"] = (torch.rand(n, l_out, generator=gen) > 0.2).to(device)
    if ext in ("residual", "all", "model", "out_mask_residual"):
        kw["residual"] = torch.randn(n, l_out, c_out, generator=gen).to(
            device, dt)
    return kw


def _plan_tag(plan: dict) -> str:
    return (f"{plan['route']} cb={plan['cb']} kw={plan['kw']} "
            f"stages={plan['stages']} smem={plan['smem']}")


def phase_int8_kernel(card: str) -> dict:
    """int8_conv against its plain versions: the requant form equal, the
    dequant form within F32_TOL / BF16_TOL, on both routes of the plan;
    then times."""
    import torch

    from jaeger_tpu_torch.ops import int8_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    # the main path's shapes take the wgmma route
    for shape in ((128, 128, 5, 1, "same", bf16), (32, 32, 3, 1, "same", bf16),
                  (128, 128, 5, 3, "same", i8)):
        plan = int8_conv.int8_plan(*shape)
        print(f"int8 plan {shape[:5]} {str(shape[5])[6:]}: {_plan_tag(plan)}")
        check(plan["route"] == "wgmma", f"int8 plan {shape}: {plan}")

    # requant: the Pallas parity case and the Pallas chip shape, then the
    # wgmma kernel's edges (L 1 / 63 / 65, N 1, C 32 / 64 / 256, C_in !=
    # C_out, k 1 / 3 / 7, CB < C_out) and a C_in = 16 shape on the mma
    # route; all equal
    scale = torch.full((1,), 1.0 / 64.0, device=dev)
    # (name, n, length, c_in, c_out, k, dilation, x range)
    requant_cases = [
        ("pallas_parity", 8, 500, 128, 128, 5, 3, 40),
        ("pallas_chip_shape", 12288, 500, 128, 128, 5, 3, 64),
        ("edge_L1", 4, 1, 128, 128, 5, 3, 64),
        ("edge_L63", 3, 63, 128, 128, 5, 3, 64),
        ("edge_L65", 3, 65, 128, 128, 5, 3, 64),
        ("edge_N1", 1, 500, 128, 128, 5, 3, 64),
        ("edge_C32_k3", 6, 300, 32, 32, 3, 1, 64),
        ("edge_C64_k3", 6, 300, 64, 64, 3, 1, 64),
        ("edge_C256_k5", 6, 300, 256, 256, 5, 1, 64),
        ("edge_C64_to_128", 6, 300, 64, 128, 5, 1, 64),
        ("edge_C128_to_48", 6, 300, 128, 48, 3, 3, 64),
        ("edge_k1", 6, 300, 128, 128, 1, 1, 64),
        ("edge_k3", 6, 300, 128, 128, 3, 1, 64),
        ("edge_k7", 6, 300, 128, 128, 7, 1, 64),
        ("mma_C16", 6, 300, 16, 32, 3, 3, 64),
    ]
    for name, n, length, c_in, c_out, k, dil, hi in requant_cases:
        x = torch.randint(-hi, hi, (n, length, c_in), generator=gen,
                          dtype=i8).to(dev)
        w = torch.randint(-8, 8, (k, c_in, c_out), generator=gen,
                          dtype=i8).to(dev)
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, "same", i8)
        before = int8_conv.launches
        out = int8_conv.int8_conv_requant(x, w, scale, dilation=dil)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_requant(x, w, scale, dilation=dil)
        diff = (out.int() - ref.int()).abs().max().item()
        print(f"int8 requant {name} N={n} L={length} C={c_in}->{c_out} k={k} "
              f"d={dil} [{_plan_tag(plan)}]: max |diff| {diff} "
              f"{'ok' if diff == 0 else 'FAIL'}")
        check(out.dtype == i8 and out.shape == ref.shape and diff == 0,
              f"{name}: requant differs from the plain version by {diff}")
        if name == "pallas_chip_shape":
            requant_x, requant_w = x, w
        del x, w, out, ref

    # dequant: each extension, the demo shape, the flagship shape,
    # dilation, then the wgmma kernel's edges in bf16 and f32 cases on the
    # mma route
    # (name, n, length, c_in, c_out, k, dilation, padding, dtype, act, ext)
    cases = []
    for dt, act in ((f32, "gelu"), (bf16, "gelu_tanh")):
        for ext in ("bias", "bias_then_dyt", "in_mask", "out_mask",
                    "residual", "all"):
            cases.append((f"{ext}_{str(dt)[6:]}", 6, 300, 128, 128, 5, 1,
                          "same", dt, act, ext))
    cases += [
        ("demo_shape_bf16", 96 * 6, 165, 32, 32, 3, 1, "same", bf16, "none",
         "in_mask"),
        ("flagship_shape_bf16", 6 * 256, 500, 128, 128, 5, 1, "same", bf16,
         "gelu_tanh", "model"),
        ("flagship_shape_f32", 6 * 32, 500, 128, 128, 5, 1, "same", f32,
         "gelu", "model"),
        ("dilation3_same_f32", 12, 62, 16, 32, 3, 3, "same", f32, "gelu",
         "in_mask"),
        ("dilation3_valid_bf16", 12, 62, 32, 48, 5, 3, "valid", bf16, "relu",
         "bias"),
        ("dilation3_flagship_bf16", 6 * 64, 500, 128, 128, 5, 3, "same", bf16,
         "none", "bias"),
        # the wgmma kernel's edges: 64-row tiles, the TMA halo, the s8
        # chunk widths (C_in 32 / 64 / 128 / 256: 32-, 64- and 128-byte
        # swizzles) and column blocks (CB < C_out), dilation in both
        # paddings, every activation
        ("edge_L1", 4, 1, 128, 128, 5, 1, "same", bf16, "gelu_tanh", "model"),
        ("edge_L63", 3, 63, 128, 128, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_L65", 3, 65, 128, 128, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_N1", 1, 500, 128, 128, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_C32_k3", 6, 300, 32, 32, 3, 1, "same", bf16, "gelu_tanh",
         "all"),
        ("edge_C64_k3", 6, 300, 64, 64, 3, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_C256_k5", 6, 300, 256, 256, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_C64_to_128", 6, 300, 64, 128, 5, 1, "same", bf16, "gelu_tanh",
         "all"),
        ("edge_C128_to_64", 6, 300, 128, 64, 5, 1, "same", bf16, "gelu_tanh",
         "all"),
        ("edge_k1", 6, 300, 128, 128, 1, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_k3", 6, 300, 128, 128, 3, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_k7", 6, 300, 128, 128, 7, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_d3_same", 6, 300, 128, 128, 5, 3, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_d3_valid", 6, 300, 128, 128, 5, 3, "valid", bf16, "gelu_tanh",
         "all"),
        ("edge_in_mask_runs", 6, 300, 128, 128, 5, 1, "same", bf16,
         "gelu_tanh", "in_mask_runs"),
        ("edge_in_mask_runs_d3", 6, 300, 64, 64, 5, 3, "same", bf16,
         "gelu_tanh", "in_mask_runs"),
        ("edge_out_mask_residual", 6, 300, 128, 128, 5, 1, "same", bf16,
         "gelu_tanh", "out_mask_residual"),
        ("edge_act_none", 6, 130, 128, 128, 3, 1, "same", bf16, "none",
         "all"),
        ("edge_act_tanh", 6, 130, 128, 128, 3, 1, "same", bf16, "tanh",
         "all"),
        ("edge_act_gelu_erf", 6, 130, 128, 128, 3, 1, "same", bf16, "gelu",
         "all"),
        ("edge_act_relu", 6, 130, 128, 128, 3, 1, "same", bf16, "relu",
         "bias"),
        ("mma_f32_L65", 3, 65, 128, 128, 5, 1, "same", f32, "gelu_tanh",
         "model"),
        ("mma_f32_d3_valid", 6, 300, 64, 64, 5, 3, "valid", f32, "gelu",
         "all"),
        ("mma_C16_bf16", 6, 300, 16, 32, 3, 1, "same", bf16, "gelu_tanh",
         "model"),
    ]
    worst = 0.0
    for name, n, length, c_in, c_out, k, dil, pad, dt, act, ext in cases:
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c_in, c_out, k, dt, dev)
        l_out = int8_conv.conv_geometry(length, k, dil, pad)[0]
        kw = dict(bias=bias, dilation=dil, padding=pad, act=act)
        kw.update(_int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt,
                                 dev))
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, pad, dt)
        before = int8_conv.launches
        out = int8_conv.int8_conv_dequant(x, w, inv_act, dq, **kw)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_dequant(x, w, inv_act, dq, **kw)
        check(out.dtype == dt and out.shape == ref.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"int8 dequant {name} [{_plan_tag(plan)}]: max_abs_err "
              f"{max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"{name}: {bad} elements beyond tolerance")
        if "out_mask" in kw and "residual" not in kw:
            check(bool((out[~kw["out_mask"]] == 0).all()),
                  f"{name}: out_mask positions not zero")
        if name == "flagship_shape_bf16":
            worst = max_err
        del x, w, out, ref, err

    times = {}
    # requant at the Pallas chip shape
    x, w = requant_x, requant_w
    n, length, c = x.shape
    k, dil = w.shape[0], 3
    shifted = shifted_copies(x, k, dil)       # made before timing

    def lib_requant():
        acc = library_int8_conv(shifted, w)
        return torch.clamp(torch.round(acc.float() * scale), -127,
                           127).to(i8)

    check(torch.equal(lib_requant().view(x.shape),
                      int8_conv.int8_conv_requant(x, w, scale, dil)),
          "requant library yardstick differs from the kernel")
    launches_before = int8_conv.launches
    ops = 2.0 * n * length * c * c * k
    nbytes = 2 * n * length * c + k * c * c + 4
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    times["requant"] = dict(
        ms=cuda_ms(lambda: int8_conv.int8_conv_requant(x, w, scale, dil),
                   iters=20),
        plain_ms=cuda_ms(lambda: int8_conv.reference_int8_conv_requant(
            x, w, scale, dil), iters=2, warmup=1),
        library_ms=cuda_ms(lib_requant, iters=5),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    del x, w, shifted, requant_x, requant_w

    # dequant at the flagship shape, bf16: conv1 and conv2 forms, and the
    # products with a bias add only (conv1 minus this is the cost of the
    # DYT + gelu_tanh epilogue)
    n, length, c, k = 6 * 2048, 500, 128, 5
    x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
        gen, n, length, c, c, k, bf16, dev)
    res = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    dyt_kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True)
    forms = {
        "conv1": (dyt_kw, "gelu_tanh"),
        "conv2": (dict(dyt_kw, residual=res), "gelu_tanh"),
        "bias_only": (dict(bias=bias), "none"),
    }

    def lib_dequant(kw, act):
        q = int8_conv.quantize_activation(x, inv_act).to(i8)
        acc = library_int8_conv(shifted_copies(q, k, 1), w)
        y = acc.view(n, length, -1).float() * dq + bias
        if "dyt" in kw:
            y = torch.tanh(y * dyt[0]) * dyt[1] + dyt[2]
        if "residual" in kw:
            y = y + kw["residual"].float()
        if act == "gelu_tanh":
            y = torch.nn.functional.gelu(y, approximate="tanh")
        return y.to(bf16)

    for form, (kw, act) in forms.items():
        ops = 2.0 * n * length * c * c * k
        nbytes = (2 * n * length * c * (3 if "residual" in kw else 2)
                  + k * c * c + 4 * (6 if "dyt" in kw else 3) * c + 4)
        t_ops = ops / PEAK_INT8_OPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        times[form] = dict(
            ms=cuda_ms(lambda: int8_conv.int8_conv_dequant(
                x, w, inv_act, dq, act=act, **kw), iters=20),
            plain_ms=cuda_ms(lambda: int8_conv.reference_int8_conv_dequant(
                x, w, inv_act, dq, act=act, **kw), iters=2, warmup=1),
            library_ms=cuda_ms(lambda: lib_dequant(kw, act), iters=3,
                               warmup=1),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    int8_conv.launches = launches_before  # timing launches are not the path
    for form, shape in (("requant", "N=12288 L=500 C=128 k=5 d=3 int8"),
                        ("conv1", "N=12288 L=500 C=128 k=5 bf16"),
                        ("conv2", "N=12288 L=500 C=128 k=5 bf16 +residual"),
                        ("bias_only", "N=12288 L=500 C=128 k=5 bf16 bias")):
        t = times[form]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        print(f"timing int8 {form} {shape} on {card}: kernel {t['ms']:.3f} "
              f"ms, plain {t['plain_ms']:.3f} ms, library "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_by']}), {t['bound_share']:.1%} of the bound, "
              f"{2.0 * 12288 * 500 * 128 * 128 * 5 / t['ms'] / 1e9:.1f} TOP/s")
    return {"max_abs_err": worst, **times["conv1"],
            "conv2": times["conv2"], "bias_only": times["bias_only"],
            "requant": times["requant"]}


def phase_int8_sweep(card: str) -> None:
    """``--sweep``: int8_conv's wgmma route under other launch plans
    (ring stages, column block) at the flagship dequant shape (bias-only
    and conv1 forms) and the Pallas requant shape, and with fewer taps
    (k = 1, 3: the same bytes, 1/5 and 3/5 of the products)."""
    import torch

    from jaeger_tpu_torch.ops import int8_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(98)
    bf16, i8 = torch.bfloat16, torch.int8
    n, length, c = 6 * 2048, 500, 128
    launches_before = int8_conv.launches
    for k in (5, 3, 1):
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c, c, k, bf16, dev)
        inv_act = inv_act.reshape(1)
        out = torch.empty_like(x)
        base = int8_conv.int8_plan(c, c, k, 1, "same", bf16)
        plans = [base]
        if k == 5:
            plans += [dict(base, cb=cb, stages=st,
                           smem=int8_conv.wgmma_plan_bytes(
                               c, k, 1, cb, base["kw"], st, bf16))
                      for cb, st in ((128, 2), (128, 3), (128, 5), (64, 4),
                                     (32, 4))]
        for plan in plans:
            if plan["smem"] > int8_conv.SMEM_LIMIT:
                continue
            for form, args in (("bias_only", (bias, None, "none")),
                               ("conv1", (bias, dyt, "gelu_tanh"))):
                b, d, act = args
                ms = cuda_ms(lambda: int8_conv._launch(
                    x, w, dq, inv_act, b, d, None, None, None, out, 1,
                    (k - 1) // 2, act, plan), iters=20)
                bound = 2.0 * n * length * c * c * k / PEAK_INT8_OPS * 1e3
                print(f"sweep int8 dequant k={k} [{_plan_tag(plan)}] {form} "
                      f"on {card}: {ms:.3f} ms (products at the int8 peak "
                      f"{bound:.3f} ms)")
        del x, w, out
    x = torch.randint(-64, 64, (n, length, c), generator=gen, dtype=i8).to(dev)
    scale = torch.full((1,), 1.0 / 64.0, device=dev)
    out = torch.empty_like(x)
    for k, dil in ((5, 3), (5, 1), (3, 1), (1, 1)):
        w = torch.randint(-8, 8, (k, c, c), generator=gen, dtype=i8).to(dev)
        base = int8_conv.int8_plan(c, c, k, dil, "same", i8)
        plans = [(base["cb"], base["stages"])]
        if (k, dil) == (5, 3):
            plans += [(128, 2), (128, 6), (64, 4)]
        for cb, st in plans:
            plan = dict(base, cb=cb, stages=st,
                        smem=int8_conv.wgmma_plan_bytes(
                            c, k, dil, cb, base["kw"], st, i8))
            if plan["smem"] > int8_conv.SMEM_LIMIT:
                continue
            ms = cuda_ms(lambda: int8_conv._launch(
                x, w, scale, None, None, None, None, None, None, out, dil,
                dil * (k - 1) // 2, "none", plan), iters=20)
            bound = 2.0 * n * length * c * c * k / PEAK_INT8_OPS * 1e3
            print(f"sweep int8 requant k={k} d={dil} [{_plan_tag(plan)}] on "
                  f"{card}: {ms:.3f} ms (products at the int8 peak "
                  f"{bound:.3f} ms)")
    int8_conv.launches = launches_before


# --- phase 3b: the fused conv's backward kernels ----------------------------

#: the train shape: batch 256 of the flagship template, six frames
TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K = 6 * 256, 500, 128, 5


def _scale_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max |ref|) in f32."""
    return ((out.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def _bf16_ulp(v):
    """One bf16 ulp (8 significant bits) at each ``|v|`` (f32)."""
    import torch

    e = torch.frexp(v.abs().clamp_min(2.0 ** -126))[1]
    return torch.exp2((e - 8).float())


def _check_close(name: str, pairs: dict, tol: float, ulps: int = 0) -> float:
    """Every output within ``tol`` of its plain version, relative to the
    plain output's scale (sums over up to N * L rows: elementwise relative
    tolerances do not apply to the near-zero ones). With ``ulps``, a bf16
    output is held element by element: within ``ulps`` bf16 ulps of the
    larger of the two values, plus ``tol`` of the scale. Returns the worst
    absolute error."""
    import torch

    worst = 0.0
    parts = []
    for key, (out, ref) in pairs.items():
        if ref is None:
            check(out is None, f"{name}: {key} expected None")
            continue
        err, scale = _scale_err(out, ref)
        limit = tol * max(scale, 1e-6)
        if ulps and out.dtype == torch.bfloat16:
            o, r = out.float(), ref.float()
            d = (o - r).abs()
            unit = _bf16_ulp(torch.maximum(o.abs(), r.abs()))
            excess = (d - ulps * unit).max().item()
            del o, r, d, unit
            ok = math.isfinite(err) and excess <= limit
            parts.append(f"{key} {err:.2e}/{scale:.2e} (beyond {ulps} ulps: "
                         f"{max(excess, 0.0) / max(scale, 1e-6):.1e} of scale)")
            check(ok, f"{name}: {key} {excess:.3e} beyond {ulps} bf16 ulps "
                  f"+ {tol} x {scale:.3e}")
        else:
            ok = math.isfinite(err) and err <= limit
            parts.append(f"{key} {err:.2e}/{scale:.2e}")
            check(ok, f"{name}: {key} err {err:.3e} beyond {tol} x "
                  f"{scale:.3e}")
        worst = max(worst, err)
    rule = f"{ulps} bf16 ulps + " if ulps else ""
    print(f"train kernel {name}: " + ", ".join(parts) + f" (tol {rule}{tol} "
          f"of scale) ok")
    return worst


def library_epilogue_bwd(dy, u, residual, out_mask, dyt):
    """Yardstick only: the same epilogue in torch ops and autograd's
    backward of it (the graph is built once, the backward timed)."""
    import torch
    import torch.nn.functional as F

    u = u.detach().requires_grad_()
    r = residual.detach().requires_grad_()
    d = dyt.detach().requires_grad_()
    y = torch.tanh(u * d[0].to(u.dtype)) * d[1].to(u.dtype) + d[2].to(u.dtype)
    y = torch.where(out_mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                        device=y.device))
    y = F.gelu(y + r, approximate="tanh")
    return lambda: torch.autograd.grad(y, (u, r, d), dy, retain_graph=True)


def phase_train_kernel(card: str) -> dict:
    """conv_wgrad, conv_epilogue_bwd and the flipped-weight data gradient
    against their plain versions (bf16 at the train shape, f32 and bf16 at
    small shapes, every form), FusedConvBlockFn's whole backward against
    the plain backward, then each kernel's time with its plain version's,
    the library yardstick's and its bound at the train shape."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2468)
    f32, bf16 = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {"conv_wgrad": 0.0, "conv_epilogue_bwd": 0.0, "dgrad": 0.0}

    def masks(n, length, kind):
        if kind == "none":
            return None
        if kind == "runs":
            m = torch.ones(n, length, dtype=torch.bool)
            for lo, hi in ((0, 3), (60, 69), (125, 131), (length - 3, length)):
                m[:, max(lo, 0):min(hi, length)] = False
            return m.to(dev)
        return (torch.rand(n, length, generator=gen) > 0.2).to(dev)

    # conv_wgrad: (name, n, length, c, k, dtype, in_mask kind); one tile
    # first (the MN-major B descriptor and the ring on the smallest case)
    for name, n, length, c, k, dt, mk in [
            ("one_tile", 1, 64, 128, 5, bf16, "none"),
            ("one_tile_masked", 1, 64, 128, 5, bf16, "random"),
            ("one_tile_C64_k3", 1, 64, 64, 3, bf16, "none"),
            ("train_shape_bf16", TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K, bf16,
             "random"),
            ("dense_bf16", 64, 500, 128, 5, bf16, "none"),
            ("f32_C128_k5", 6, 300, 128, 5, f32, "random"),
            ("f32_C16_k3", 12, 100, 16, 3, f32, "runs"),
            ("edge_L1", 4, 1, 128, 5, bf16, "none"),
            ("edge_L63", 3, 63, 128, 5, bf16, "random"),
            ("edge_L65", 3, 65, 128, 5, bf16, "runs"),
            ("edge_C64_k3", 6, 300, 64, 3, bf16, "random"),
            ("edge_C256_k5", 6, 300, 256, 5, bf16, "random"),
            ("edge_L64_k3_runs", 3, 64, 128, 3, bf16, "runs"),
            ("edge_L500_k3", 4, 500, 128, 3, bf16, "random"),
            ("edge_C64_k5_runs", 6, 300, 64, 5, bf16, "runs"),
            ("edge_C256_k3", 6, 300, 256, 3, bf16, "none"),
            ("edge_runs_C128_k5", 6, 300, 128, 5, bf16, "runs")]:
        x = torch.randn(n, length, c, generator=gen).to(dev, dt)
        du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev, dt)
        im = masks(n, length, mk)
        before = fg.launches["conv_wgrad"]
        dw, db = fg.conv_wgrad(x, du, im, k)
        torch.cuda.synchronize()
        check(fg.launches["conv_wgrad"] == before + 1,
              f"conv_wgrad {name}: kernel not launched")
        rdw, rdb = fg.reference_conv_wgrad(x, du, im, k)
        plan = fg.wgrad_plan(n, length, c, k, dt, sms)
        again = fg.conv_wgrad(x, du, im, k)
        check(torch.equal(again[0], dw) and torch.equal(again[1], db),
              f"conv_wgrad {name}: not the same bits run to run")
        worst["conv_wgrad"] = max(worst["conv_wgrad"], _check_close(
            f"conv_wgrad {name} N={n} L={length} C={c} k={k} "
            f"{str(dt)[6:]} mask={mk} [{plan['route']} groups="
            f"{plan['groups']}x{plan['group']} co_block={plan['co_block']}]",
            {"dW": (dw, rdw), "db": (db, rdb)},
            F32_TOL if dt == f32 else 1e-3))
        del x, du, dw, db, rdw, rdb

    # conv_epilogue_bwd: (name, n, length, c, dtype, act, residual, out
    # mask, DYT): the train shapes, then every activation with and without
    # each of residual, out mask and DYT in both types, at C 16 / 48 / 128 /
    # 256 and row counts that are no multiple of a chunk or of the stages
    epi_cases = [
        ("conv1_train_bf16", TRAIN_N, TRAIN_L, TRAIN_C, bf16, "gelu_tanh",
         False, True, True),
        ("conv2_train_bf16", TRAIN_N, TRAIN_L, TRAIN_C, bf16, "gelu_tanh",
         True, True, True),
        ("conv2_f32_gelu", 6, 300, 128, f32, "gelu", True, True, True),
        ("conv1_f32_relu", 6, 300, 128, f32, "relu", False, True, True),
        ("conv1_f32_tanh", 6, 300, 48, f32, "tanh", False, True, True),
        ("conv2_f32_none", 6, 300, 16, f32, "none", True, True, True),
        ("bias_f32_outmask", 6, 300, 32, f32, "gelu", False, True, False)]
    shapes = ((3, 37, 16), (5, 61, 48), (7, 113, 128), (2, 499, 256))
    i = 0
    for dt in (f32, bf16):
        for act in ("none", "relu", "tanh", "gelu", "gelu_tanh"):
            for has_r in (False, True):
                for has_om in (False, True):
                    for has_dyt in (False, True):
                        n, length, c = shapes[i % len(shapes)]
                        i += 1
                        epi_cases.append((
                            f"form_{str(dt)[6:]}_{act}_r{int(has_r)}"
                            f"_om{int(has_om)}_dyt{int(has_dyt)}", n, length,
                            c, dt, act, has_r, has_om, has_dyt))
    for name, n, length, c, dt, act, has_r, has_om, has_dyt in epi_cases:
        dy = torch.randn(n, length, c, generator=gen).to(dev, dt)
        u = torch.randn(n, length, c, generator=gen).to(dev, dt)
        r = (torch.randn(n, length, c, generator=gen).to(dev, dt)
             if has_r else None)
        om = masks(n, length, "random") if has_om else None
        dyt = None if not has_dyt else torch.stack([
            torch.full((c,), 0.7), torch.randn(c, generator=gen),
            torch.randn(c, generator=gen)]).to(dev)
        before = fg.launches["conv_epilogue_bwd"]
        du, dr, dd = fg.conv_epilogue_bwd(dy, u, r, om, dyt, act)
        torch.cuda.synchronize()
        check(fg.launches["conv_epilogue_bwd"] == before + 1,
              f"conv_epilogue_bwd {name}: kernel not launched")
        again = fg.conv_epilogue_bwd(dy, u, r, om, dyt, act)
        check(all(a is None and b is None or torch.equal(a, b)
                  for a, b in zip(again, (du, dr, dd))),
              f"conv_epilogue_bwd {name}: not the same bits run to run")
        rdu, rdr, rdd = fg.reference_conv_epilogue_bwd(dy, u, r, om, dyt, act)
        plan = fg.epilogue_plan(n * length, c, dt, has_r, sms)
        worst["conv_epilogue_bwd"] = max(
            worst["conv_epilogue_bwd"], _check_close(
                f"conv_epilogue_bwd {name} N={n} L={length} C={c} {act} "
                f"[R={plan['rows_per_chunk']} ctas={plan['ctas']}]",
                {"du": (du, rdu), "dr": (dr, rdr if r is not None else None),
                 "ddyt": (dd, rdd)},
                *((F32_TOL,) if dt == f32 else BF16_KERNEL_TOL)))
        del dy, u, r, du, dr, rdu, rdr, again

    # the data gradient: fused_conv_block with the flipped weights, against
    # its plain version and against autograd of the plain conv
    for name, n, length, c, k, dt, mk in [
            ("train_shape_bf16", TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K, bf16,
             "random"),
            ("f32_C128_k5", 6, 300, 128, 5, f32, "runs"),
            ("f32_C16_k3", 12, 100, 16, 3, f32, "random"),
            ("bf16_C32_k3", 6, 300, 32, 3, bf16, "random")]:
        du = torch.randn(n, length, c, generator=gen).to(dev, dt)
        w = (torch.randn(k, c, c, generator=gen) * 0.05).to(dev, dt)
        im = masks(n, length, mk)
        before = fused_conv.launches
        dx = fused_conv.fused_conv_block(du, fg.flipped_weights(w),
                                         out_mask=im)
        torch.cuda.synchronize()
        check(fused_conv.launches == before + 1,
              f"dgrad {name}: kernel not launched")
        ref = fused_conv.reference_conv_block(du, fg.flipped_weights(w),
                                              out_mask=im)
        pairs = {"dx": (dx, ref)}
        if dt == f32:
            xv = torch.zeros(n, length, c, device=dev, requires_grad=True)
            y = fused_conv.reference_conv_block(xv, w, in_mask=im)
            pairs["dx_vs_autograd"] = (
                dx, torch.autograd.grad(y, xv, du)[0])
        worst["dgrad"] = max(worst["dgrad"], _check_close(
            f"dgrad {name} N={n} L={length} C={c} k={k} {str(dt)[6:]}",
            pairs, *((F32_TOL,) if dt == f32 else BF16_KERNEL_TOL)))
        del du, w, dx, ref

    # FusedConvBlockFn's whole backward against the plain backward
    n, length, c, k = TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K
    x = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    w = (torch.randn(k, c, c, generator=gen) * 0.05).to(dev)
    b = torch.randn(c, generator=gen).to(dev)
    dyt = torch.stack([torch.full((c,), 0.7), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(dev)
    r = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    im, om = masks(n, length, "random"), masks(n, length, "random")
    dy = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    for form, kw in (("conv1", dict(dyt=dyt, act="gelu_tanh",
                                    bias_then_dyt=True, in_mask=im,
                                    out_mask=om)),
                     ("conv2", dict(dyt=dyt, act="gelu_tanh",
                                    bias_then_dyt=True, in_mask=im,
                                    out_mask=om, residual=r)),
                     ("bias_only", dict(in_mask=im))):
        got = fg.conv_block_backward(dy, x, w, b, **kw)
        ref = fg.reference_conv_block_backward(dy, x, w, b, **kw)
        _check_close(f"FusedConvBlockFn backward {form} train shape bf16",
                     dict(zip(("dx", "dW", "db", "ddyt", "dr"),
                              zip(got, ref))), *BF16_BACKWARD_TOL)

    # times at the train shape (bf16), each with its bound
    du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev, bf16)
    wb = w.to(bf16)
    launches_before = dict(fg.launches), fused_conv.launches
    times = {}
    flops = 2.0 * n * length * c * c * k
    # conv_wgrad: x and du in, dW and db out
    x_ncl = x.transpose(1, 2).contiguous()
    du_ncl = du.transpose(1, 2).contiguous()
    nbytes = 2 * 2 * n * length * c + n * length + 4 * (k * c * c + c)
    times["conv_wgrad"] = dict(
        ms=cuda_ms(lambda: fg.conv_wgrad(x, du, im, k), iters=20),
        plain_ms=cuda_ms(lambda: fg.reference_conv_wgrad(x, du, im, k),
                         iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
            x_ncl, (c, c, k), du_ncl, padding=(k - 1) // 2), iters=10),
        host_us=host_us(lambda: fg.conv_wgrad(x, du, im, k)),
        flops=flops, bytes=nbytes, plan=fg.wgrad_plan(n, length, c, k, bf16,
                                                      sms))
    del x_ncl
    # conv_epilogue_bwd, conv2 form: dy, u, r, out_mask in; du, dr out
    u = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    lib = library_epilogue_bwd(dy, u, r, om, dyt)
    nbytes = 5 * 2 * n * length * c + n * length + 2 * 12 * c
    times["conv_epilogue_bwd"] = dict(
        ms=cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, r, om, dyt,
                                                "gelu_tanh"), iters=20),
        plain_ms=cuda_ms(lambda: fg.reference_conv_epilogue_bwd(
            dy, u, r, om, dyt, "gelu_tanh"), iters=3, warmup=1),
        library_ms=cuda_ms(lib, iters=10), flops=0.0, bytes=nbytes,
        host_us=host_us(lambda: fg.conv_epilogue_bwd(dy, u, r, om, dyt,
                                                     "gelu_tanh")),
        plan=fg.epilogue_plan(n * length, c, bf16, True, sms))
    nbytes1 = 3 * 2 * n * length * c + n * length + 2 * 12 * c
    conv1_ms = cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, None, om, dyt,
                                                    "gelu_tanh"), iters=20)
    del lib
    # the data gradient: du in, dx out, flipped weights
    wf = fg.flipped_weights(wb)
    nbytes = 2 * 2 * n * length * c + 2 * k * c * c + n * length
    times["dgrad"] = dict(
        ms=cuda_ms(lambda: fused_conv.fused_conv_block(du, wf, out_mask=im),
                   iters=20),
        plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
            du, wf, out_mask=im), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
            (n, c, length), wb.permute(2, 1, 0), du_ncl,
            padding=(k - 1) // 2), iters=10),
        flops=flops, bytes=nbytes)
    fg.launches.update(launches_before[0])
    fused_conv.launches = launches_before[1]
    for key, t in times.items():
        t_ops = t["flops"] / PEAK_BF16_FLOPS * 1e3
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t.update(bound_ms=max(t_ops, t_bytes), max_abs_err=worst[key],
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        t["bound_share"] = t["bound_ms"] / t["ms"]
        print(f"timing {key} N={n} L={length} C={c} k={k} bf16 on {card}: "
              f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"library {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} "
              f"ms ({t['bound_by']}: {t['flops']:.3e} FLOP, "
              f"{t['bytes'] / 1e9:.3f} GB), {t['bound_share']:.1%} of the "
              f"bound" + (f"; host {t['host_us']:.1f} us a call"
                          if "host_us" in t else ""))
    times["conv_epilogue_bwd"]["conv1_ms"] = conv1_ms
    times["conv_epilogue_bwd"]["conv1_bound_ms"] = (
        nbytes1 / HBM_BYTES_PER_S * 1e3)
    print(f"timing conv_epilogue_bwd conv1 form on {card}: {conv1_ms:.3f} ms, "
          f"bound {nbytes1 / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")
    return times


def phase_train_sweep(card: str) -> None:
    """``--sweep``: conv_wgrad under other ring depths, with and without
    in_mask, and conv_epilogue_bwd with and without the out mask, at the
    train shape; then where each wrapper's host time goes (cProfile over
    100 calls that do not wait for the card)."""
    import cProfile
    import io
    import pstats

    import torch

    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(97)
    n, length, c, k = TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = dict(fg.launches)
    x = torch.randn(n, length, c, generator=gen).to(dev, torch.bfloat16)
    du = (torch.randn(n, length, c, generator=gen) * 0.1).to(
        dev, torch.bfloat16)
    im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
    for stages in (2, 3, 4):
        plan = fg.wgrad_plan(n, length, c, k, torch.bfloat16, sms, stages)
        for mname, m in (("none", None), ("random", im)):
            ms = cuda_ms(lambda: fg.conv_wgrad(x, du, m, k, plan=plan),
                         iters=20)
            print(f"sweep conv_wgrad stages={stages} in_mask={mname} on "
                  f"{card}: {ms:.3f} ms")
    dy, u, r = x, du, torch.randn(n, length, c, generator=gen).to(
        dev, torch.bfloat16)
    dyt = torch.stack([torch.full((c,), 0.7), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(dev)
    for form, res in (("conv2", r), ("conv1", None)):
        for mname, m in (("none", None), ("random", im)):
            ms = cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, res, m, dyt,
                                                      "gelu_tanh"), iters=20)
            print(f"sweep conv_epilogue_bwd {form} out_mask={mname} on "
                  f"{card}: {ms:.3f} ms")
    # what a plain read/write stream reaches on this card, as a yardstick
    # for the epilogue's bytes: copy (1 read, 1 write) and add (2, 1)
    out = torch.empty_like(dy)
    for name, fn, nbytes in (
            ("copy_", lambda: out.copy_(dy), 2 * dy.numel() * 2),
            ("add", lambda: torch.add(dy, u, out=out), 3 * dy.numel() * 2)):
        ms = cuda_ms(fn, iters=20)
        print(f"sweep stream {name} {nbytes / 1e9:.3f} GB on {card}: "
              f"{ms:.3f} ms, {nbytes / ms / 1e9:.2f} TB/s")
    del out
    print_device_profile(lambda: [fg.conv_wgrad(x, du, im, k)
                                  for _ in range(10)], "conv_wgrad x10", top=3)
    print_device_profile(lambda: [fg.conv_epilogue_bwd(
        dy, u, r, im, dyt, "gelu_tanh") for _ in range(10)],
        "conv_epilogue_bwd conv2 x10", top=3)
    for name, fn in (
            ("conv_wgrad", lambda: fg.conv_wgrad(x, du, im, k)),
            ("conv_epilogue_bwd", lambda: fg.conv_epilogue_bwd(
                dy, u, r, im, dyt, "gelu_tanh"))):
        fn()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(100):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
        print(f"sweep host profile of {name} (100 calls):")
        print("\n".join(line for line in out.getvalue().splitlines()
                        if line.strip())[:3000])
    fg.launches.update(saved)


# --- phase 6: training --------------------------------------------------------

TEMPLATE = ROOT / "train_config" / "fragment_6class_1500bp.yaml"


def narrow_train_config() -> dict:
    """The flagship training template cut to C = 16, a 40-codon crop and
    narrow heads (phase 6a's card-vs-CPU step)."""
    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(TEMPLATE)
    m = cfg["model"]
    m["embedding"]["embedding_size"] = 8
    m["string_processor"]["crop_size"] = 40
    for layer in m["representation_learner"]["hidden_layers"]:
        if "filters" in (layer.get("config") or {}):
            layer["config"]["filters"] = 16
    m["reliability_model"]["hidden_layers"][0]["config"]["units"] = 8
    return cfg


def _train_batch(rng, crop: int, program: str, n: int, n_classes: int):
    import numpy as np

    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.full(n, crop, np.int32)
    if program == "bounded":
        bases[np.arange(n), rng.integers(20, crop - 20, size=n)] = 4
    elif program == "masked":
        bases[0, 20:60] = 4
        lengths[1] = crop // 2
    labels = np.zeros((n, n_classes), np.float32)
    labels[np.arange(n), rng.integers(0, n_classes, size=n)] = 1.0
    return {"bases": bases, "lengths": lengths, "labels": labels}


def phase_train_step_f32() -> dict:
    """One f32 train step of the narrow template on the card against the
    same step on the CPU, in each program (dense, bounded, masked): the
    loss within 1e-5, every gradient leaf within 1e-4 of its scale (a leaf
    below 1e-4 of the largest gradient is rounding noise around an exact
    zero and is held at 1e-4 of the largest), the batch statistics within
    1e-5 of their scale, and the parameters after the AdamW step within
    2e-3 of the update where the gradient is clearly nonzero (|g| > 1e-4
    and > 1e-3 of the leaf's largest; Adam's first step is close to
    lr * sign(g)) and within 2 lr everywhere. TF32 is off for cuDNN and
    cuBLAS (the entry conv and the dense heads). The card's step must
    launch every backward kernel."""
    import copy

    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = narrow_train_config()
    tcfg = cfg["training"]
    lr = float(tcfg["optimizer_params"]["learning_rate"])
    rng = np.random.default_rng(17)
    worst = {}
    for program in ("dense", "bounded", "masked"):
        runs = {}
        batch = None
        for dev in ("cuda", "cpu"):
            model = build_model(copy.deepcopy(cfg))
            load_state(model, init_params(cfg, torch.Generator().manual_seed(
                5)))
            init = {k: v.detach().clone() for k, v in
                    loop.flax_params(model).items()}
            model.to(dev)
            if batch is None:
                batch = _train_batch(rng, model.crop_nt, program, 8, 6)
            tx = make_optimizer(tcfg["optimizer"], tcfg["optimizer_params"])
            state = loop.TrainState.create(model, tx)
            step = loop.make_dispatching_train_step(
                model, loop.StepConfig(
                    loss_name=tcfg["loss_classifier"],
                    loss_params=tcfg["loss_params_classifier"],
                    heads=("prediction",)), dev)
            before = (dict(fg.launches), fused_conv.launches)
            state, metrics = step(state, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
                added = {k: fg.launches[k] - before[0][k] for k in fg.launches}
                added["fused_conv_block"] = fused_conv.launches - before[1]
                check(all(v > 0 for v in added.values()),
                      f"f32 step {program}: launches {added}")
            check(step.program_counts == {program: 1},
                  f"f32 step {program}: ran {step.program_counts}")
            runs[dev] = dict(
                loss=float(metrics["loss"]),
                grads={k: v.float().cpu() for k, v in state.grads.items()},
                stats={k: v.cpu() for k, v in model.state_dict().items()
                       if "moving" in k},
                params={k: v.detach().cpu() for k, v in
                        loop.flax_params(model).items()})
        gpu, cpu = runs["cuda"], runs["cpu"]
        check(abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * max(abs(cpu["loss"]),
                                                            1.0),
              f"f32 step {program}: loss {gpu['loss']} vs {cpu['loss']}")
        overall = max(float(g.abs().max()) for g in cpu["grads"].values())
        g_err = 0.0
        for k, g in cpu["grads"].items():
            scale = max(float(g.abs().max()), 1e-12)
            if scale < 1e-4 * overall:
                scale = overall
            e = float((gpu["grads"][k] - g).abs().max()) / scale
            check(e <= 1e-4, f"f32 step {program}: grad {k} rel err {e:.2e}")
            g_err = max(g_err, e)
        for k, s in cpu["stats"].items():
            e = float((gpu["stats"][k] - s).abs().max())
            check(e <= 1e-5 * max(float(s.abs().max()), 1e-6),
                  f"f32 step {program}: {k} err {e:.2e}")
        for k, p in cpu["params"].items():
            g = cpu["grads"][k].abs()
            big = (g > 1e-4) & (g > 1e-3 * float(g.max()))
            du_gpu, du_cpu = gpu["params"][k] - init[k], p - init[k]
            diff = (du_gpu - du_cpu).abs()
            check(bool((diff <= 2 * lr + 1e-7).all()),
                  f"f32 step {program}: {k} update beyond 2 lr")
            check(bool((diff[big] <= 2e-3 * du_cpu[big].abs() + 1e-7).all()),
                  f"f32 step {program}: {k} update beyond 2e-3")
        worst[program] = g_err
        print(f"train step f32 {program} (narrow template, card vs CPU): "
              f"loss {gpu['loss']:.6f} vs {cpu['loss']:.6f}, worst grad "
              f"err {g_err:.2e} of its scale (tol 1e-4) ok")
    return worst


def write_train_data(root: Path, seed: int, crop_nt: int) -> dict:
    """Synthetic ``label,sequence`` CSVs for the template, made from
    ``seed``: six classes whose GC content differs (0.2 to 0.8), so the
    loss can fall. The training file holds a block of 16 rows with one
    interior N each (rows 2048-2063) and a block of 8 with long N runs or
    short lengths (rows 3072-3079) amid full-length clean rows. Each epoch
    streams the file from its start through a 1024-row shuffle buffer, so
    of an epoch's ten batches of 256 the first four take the dense
    program, the next ones (the first block in the buffer) the bounded
    one and the last two (the second block too) the masked one. The reliability files hold ID rows (label 1, the classes'
    composition) and OOD rows (label 0, uniform bases)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.array(list("ACGT"))

    def seq(label, length):
        gc = 0.2 + 0.12 * label
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        return "".join(acgt[rng.choice(4, size=length, p=p)])

    def write(path, rows):
        path.write_text("".join(f"{lab},{s}\n" for lab, s in rows))
        return str(path)

    length = crop_nt + 95
    train = []
    for i in range(8192):
        lab = int(rng.integers(0, 6))
        s = seq(lab, length)
        if 2048 <= i < 2064:        # one N: a short invalid run
            j = int(rng.integers(300, crop_nt - 300))
            s = s[:j] + "N" + s[j + 1:]
        elif 3072 <= i < 3080:      # long N runs or short rows
            s = (s[:400] + "N" * 300 + s[700:]) if i % 2 else s[:900]
        train.append((lab, s))
    val = [(int(lab), seq(int(lab), length))
           for lab in rng.integers(0, 6, size=512)]
    rel = [(1, seq(int(rng.integers(0, 6)), length)) if i % 2 else
           (0, "".join(acgt[rng.integers(0, 4, size=length)]))
           for i in range(2048)]
    return {"train": write(root / "train.csv", train),
            "val": write(root / "val.csv", val),
            "rel_train": write(root / "rel_train.csv", rel[:1536]),
            "rel_val": write(root / "rel_val.csv", rel[1536:])}


def flagship_train_config(root: Path, data: dict) -> Path:
    """The template with the synthetic data, 3 epochs x 10 classifier steps
    (30), 1 x 4 reliability steps, 2 validation steps and a 1024-row
    shuffle buffer; the model, batch 256, bf16, the optimizer, losses and
    callbacks as the template has them."""
    import yaml

    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(TEMPLATE)
    t = cfg["training"]
    cfg["model"]["string_processor"]["buffer_size"] = 1024
    t.update(classifier_epochs=3, classifier_train_steps=10,
             classifier_validation_steps=2, reliability_epochs=1,
             reliability_train_steps=4, reliability_validation_steps=2)
    classes = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    t["fragment_classifier_data"] = {
        "train": [{"class": classes, "path": [data["train"]],
                   "label": list(range(6))}],
        "validation": [{"class": classes, "path": [data["val"]],
                        "label": list(range(6))}]}
    t["fragment_reliability_data"] = {
        "train": [{"class": ["ood", "id"], "path": [data["rel_train"]],
                   "label": [0, 1]}],
        "validation": [{"class": ["ood", "id"], "path": [data["rel_val"]],
                        "label": [0, 1]}]}
    path = root / "flagship_train.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def phase_train_flagship(tmp: Path, card: str) -> dict:
    """The main path of this slice: ``train_fragment_core`` with the
    flagship template at full width (batch 256, bf16) on synthetic data:
    about 30 classifier steps and 4 reliability steps, then the export
    and the int8 bundle. Checks finite, falling losses, all three
    programs, the kernels' launches per dense step, the bundle and its
    int8 bundle; prints steps/s and windows/s per program and the peak
    device memory."""
    import torch

    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.utils.config import load_model_config

    crop_nt = 1505
    t0 = time.perf_counter()
    data = write_train_data(tmp, seed=20261016, crop_nt=crop_nt)
    cfg_path = flagship_train_config(tmp, data)
    data_s = time.perf_counter() - t0
    out = tmp / "trained"
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    for k in fg.launches:
        fg.launches[k] = 0
    t0 = time.perf_counter()
    results = train_fragment_core(str(cfg_path), str(out))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fg.launches, fused_conv_block=fused_conv.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = results["history"]
    cls = hist["classifier"]
    losses = [h["loss"] for h in cls]
    check(len(cls) == 3 and all(math.isfinite(v) for v in losses),
          f"classifier history {losses}")
    check(losses[-1] < losses[0], f"classifier loss did not fall: {losses}")
    rel = [h["loss"] for h in hist.get("reliability", [])]
    check(len(rel) == 1 and all(math.isfinite(v) for v in rel),
          f"reliability history {rel}")
    progs = results["programs"]["classifier"]
    check(set(progs) == {"dense", "bounded", "masked"}
          and sum(progs.values()) == 30, f"classifier programs {progs}")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    for f in ("params.msgpack", "project.yaml", "classes.yaml",
              "history.csv", "checkpoints/classifier/checkpoints.json",
              "int8/params_int8.msgpack"):
        check((out / f).exists(), f"train wrote no {f}")
    check(results.get("int8_path") == str(out / "int8"),
          "train did not write the int8 bundle")
    model8, _, _ = load_model(out / "int8", dtype=torch.bfloat16)
    n8 = sum(1 for m in model8.modules() if getattr(m, "int8", False))
    check(n8 >= 6, f"int8 bundle: {n8} int8 convs")

    # launches of one dense step, counted alone; steady-state step times
    per_step, steady = _step_rates(out, load_model_config(cfg_path), card)
    check(per_step == {"fused_conv_block": 18, "conv_wgrad": 6,
                       "conv_epilogue_bwd": 6},
          f"launches per dense step {per_step}")
    print(f"train flagship template (batch 256, bf16) on {card}: "
          f"{train_s:.1f} s in all (data {data_s:.1f} s), classifier losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f", reliability loss {rel[0]:.4f}, threshold "
          f"{results.get('reliability_threshold')}, peak device memory "
          f"{peak_gb:.2f} GB, main-path launches {launches}")
    print(f"train programs {progs}; launches per dense step: {per_step}")
    return dict(launches=launches, per_step=per_step, programs=progs,
                steady=steady, losses=losses, peak_gb=peak_gb,
                train_s=train_s, bundle=out)


#: the conv kernels of a train step, by the name the profiler gives them
CONV_KERNELS = ("conv_bf16_wgmma", "wgrad_bf16", "reduce_splits",
                "conv_epilogue_bwd", "reduce_parts")


def _step_rates(bundle: Path, cfg: dict, card: str) -> tuple[dict, dict]:
    """Kernel launches of one dense classifier step of the trained model
    (batch 256, bf16), and each program's steady-state step time (warm,
    then 10 steps that do not wait for the card, on the host clock between
    two synchronizes) beside the host's time for choosing the program
    (``dense_window_batch`` and ``bounded_mask_levels`` on the batch, as
    the dispatcher runs them, overlapped with the previous step's device
    work), and the dense step's device time by kernel and the conv
    kernels' share of it."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.builder import mask_cut_plan
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.ops.encode import (bounded_mask_levels,
                                             dense_window_batch)
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    model, _, _ = load_model(bundle, dtype=torch.bfloat16)
    plans = mask_cut_plan(model.config["representation_learner"])
    t = cfg["training"]
    state = loop.TrainState.create(model, make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    step = loop.make_dispatching_train_step(model, loop.StepConfig(
        loss_name=t["loss_classifier"],
        loss_params=t["loss_params_classifier"], heads=("prediction",)),
        "cuda")
    rng = np.random.default_rng(3)
    batches = {p: _train_batch(rng, model.crop_nt, p, 256, 6)
               for p in ("dense", "bounded", "masked")}
    saved = dict(fg.launches), fused_conv.launches
    steady = {}
    for program, batch in batches.items():
        state, _ = step(state, batch)            # warm
        before = dict(fg.launches), fused_conv.launches
        state, _ = step(state, batch)
        if program == "dense":
            got = {k: fg.launches[k] - before[0][k] for k in fg.launches}
            got["fused_conv_block"] = fused_conv.launches - before[1]
        reps = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        if not dense_window_batch(batch["bases"], batch["lengths"],
                                  model.crop_nt, model.masking_enabled):
            bounded_mask_levels(batch["bases"], batch["lengths"],
                                model.crop_nt, model.masking_enabled, plans)
        plan_ms = (time.perf_counter() - t0) * 1e3
        # the host's whole share of one step on an idle card: plan, upload
        # and launches, until the call returns (median of 3)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms = sorted(host)[1]
        steady[program] = dict(step_ms=ms, steps_per_s=1e3 / ms,
                               windows_per_s=256 / ms * 1e3,
                               host_plan_ms=plan_ms, host_step_ms=host_ms)
        print(f"train {program} step (batch 256, bf16) on {card}: "
              f"{ms:.2f} ms, {1e3 / ms:.2f} steps/s, {256 / ms * 1e3:.0f} "
              f"windows/s; host {host_ms:.1f} ms a step, of it the plan "
              f"{plan_ms:.1f} ms")
    check(set(step.program_counts) == set(batches),
          f"steady-state programs {step.program_counts}")
    for program, batch in batches.items():
        by_kernel = print_device_profile(lambda: step(state, batch),
                                         f"train {program} step",
                                         top=14 if program == "dense" else 4)
        device_ms = sum(by_kernel.values())
        conv_ms = sum(v for k, v in by_kernel.items()
                      if any(c in k for c in CONV_KERNELS))
        st = steady[program]
        st.update(device_ms=device_ms, conv_kernels_ms=conv_ms,
                  conv_share=conv_ms / device_ms,
                  device_busy=device_ms / st["step_ms"])
        print(f"train {program} step: {device_ms:.2f} ms of device time "
              f"({st['device_busy']:.1%} of the steady step), {conv_ms:.2f} "
              f"ms ({conv_ms / device_ms:.1%}) in the conv kernels (forward, "
              f"recomputed u, data gradient, conv_wgrad, conv_epilogue_bwd)")
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    return got, steady


def phase_train_predict(tmp: Path, bundle: Path) -> dict:
    """``predict`` and ``predict --int8`` with the bundle ``train`` wrote
    (its ``int8`` bundle beside it) on the test contigs."""
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    labels = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    counts = {}
    for name, extra in (("trained", []), ("trained_int8", ["--int8"])):
        f0, i0 = fused_conv.launches, int8_conv.launches
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / name), "-m",
                  str(bundle), "--fsize", "1505", "--batch", "256"] + extra)
        counts[name] = (fused_conv.launches - f0, int8_conv.launches - i0)
        _check_tsv(_read_tsv(tmp / name / "test_contigs_default_jaeger.tsv"),
                   labels, f"predict {name}")
    check(counts["trained"][0] > 0 and counts["trained_int8"][1] > 0
          and counts["trained_int8"][0] == 0,
          f"predict on the trained bundle: launches {counts}")
    print(f"predict with the trained bundle: fused_conv_block launches "
          f"{counts['trained'][0]}; --int8: int8_conv launches "
          f"{counts['trained_int8'][1]}")
    return counts


# --- phase 4 ---------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Run the model's convs on the kernels' plain versions instead."""
    from jaeger_tpu_torch.models import layers
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    saved = layers.fused_conv_block, layers.int8_conv_dequant
    layers.fused_conv_block = fused_conv.reference_conv_block
    layers.int8_conv_dequant = int8_conv.reference_int8_conv_dequant
    try:
        yield
    finally:
        layers.fused_conv_block, layers.int8_conv_dequant = saved


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


def print_device_profile(fn, label: str, top: int = 8) -> dict:
    """Device time by kernel name over one call of ``fn``, printed; returns
    milliseconds by kernel name."""
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
    return {e.key: e.self_device_time_total / 1e3 for e in events}


def _drive_flagship(model, label: str, per_forward: dict,
                    profile: bool) -> dict:
    """The flagship ``model`` through the engine at batch 2048 on windows
    that select the dense, the bounded and the split programs: kernel
    launches per forward (``per_forward``: launches of each kernel module
    per forward), the forward against the same forward on the plain
    versions (5e-2 of scale), windows/s and the host's planning time."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.infer.engine import InferenceEngine

    bs = 2048
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
        before = {mod: mod.launches for mod in per_forward}
        out = eng.predict_windows(bases, lengths)
        torch.cuda.synchronize()
        forwards = sum(eng.program_counts.values())
        ran = set(eng.program_counts)
        if kind == "bounded":
            check(cut is not None and split is None and not dense,
                  f"bounded windows planned as {(dense, split, cut)}")
            expect["bounded"] = {(bs, ("bounded", cut))}
        check(ran == expect[kind], f"{label} {kind}: programs {ran}")
        added = {mod: mod.launches - before[mod] for mod in per_forward}
        for mod, n in per_forward.items():
            check(added[mod] == n * forwards,
                  f"{label} {kind}: {added[mod]} {mod.__name__} launches "
                  f"for {forwards} forwards, expected {n} each")
        for k, v in out.items():
            check(bool(np.isfinite(v).all()) and v.shape[0] == bs,
                  f"{label} {kind}: output {k} {v.shape} not finite")
        # the same forward on the plain versions, on the card
        tb = torch.from_numpy(bases).cuda()
        tl = torch.from_numpy(lengths).cuda()
        prog = dict(assume_dense=dense, mask_layers=None if dense else cut)
        if split is not None:
            prog = dict(assume_dense=False, mask_layers=None)
        with torch.inference_mode():
            a = model(tb, tl, **prog)
            with plain_kernels():
                b = model(tb, tl, **prog)
        errs = {k: (a[k].float() - b[k].float()).abs().max().item()
                for k in a}
        for k in a:
            scale = b[k].float().abs().max().item()
            check(errs[k] <= BF16_TOL * max(scale, 1e-3),
                  f"{label} {kind}: {k} kernel vs plain {errs[k]:.3e} "
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
                                     f"{label} {kind} forward")
        rates[kind] = dict(engine_windows_per_s=eng_rate,
                           forward_ms=fwd_ms,
                           forward_windows_per_s=bs / fwd_ms * 1e3,
                           host_plan_ms=plan_ms)
        launched = ", ".join(f"{n} {m.__name__.rsplit('.', 1)[-1]}"
                             for m, n in added.items())
        print(f"{label} {kind}: programs {sorted(map(str, ran))}, "
              f"{launched} launches / {forwards} forwards, kernel vs plain "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; engine {eng_rate:.0f} windows/s, forward "
              f"{fwd_ms:.2f} ms ({bs / fwd_ms * 1e3:.0f} windows/s), host "
              f"plan {plan_ms:.1f} ms")
        del tb, tl, a, b
    return rates


def phase_flagship(profile: bool = False) -> dict:
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.models.flagship import flagship_config
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    cfg = flagship_config()
    model = build_model(cfg, dtype=torch.bfloat16)
    load_state(model, init_params(cfg, torch.Generator().manual_seed(42)))
    return _drive_flagship(model, "flagship", {fused_conv: 6, int8_conv: 0},
                           profile)


def phase_int8_flagship(bundle: Path, profile: bool = False) -> dict:
    """Calibrate the seeded flagship bundle with the port's
    ``quantize_bundle(mode="full_int8")`` on the card (written beside it
    as ``<bundle>_int8``, where ``predict --int8`` finds it), then drive
    its int8 forward: six int8_conv launches and no fused_conv_block
    launch per forward."""
    import torch

    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.conversion import (int8_conv_count,
                                                    quantize_bundle)
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    t0 = time.perf_counter()
    stats = quantize_bundle(bundle, f"{bundle}_int8", mode="full_int8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    check(stats["int8_exec_convs"] == 6,
          f"flagship full_int8: {stats['int8_exec_convs']} int8 convs")
    model, _, _ = load_model(f"{bundle}_int8", dtype=torch.bfloat16)
    check(int8_conv_count(model) == 6, "flagship int8 model: not 6 convs")
    print(f"quantize flagship full_int8 on the card: {stats} in "
          f"{quant_s:.1f} s")
    rates = _drive_flagship(model, "flagship int8",
                            {int8_conv: 6, fused_conv: 0}, profile)
    rates["quantize_s"] = quant_s
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


def flagship_bundle(tmp: Path) -> Path:
    """The seeded flagship (random weights, seed 42) as a bundle."""
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, save_model
    from jaeger_tpu_torch.models.flagship import flagship_config

    cfg = flagship_config()
    return save_model(init_params(cfg, torch.Generator().manual_seed(42)),
                      cfg, tmp / "flagship_bundle")


def _max_score_diff(rows: list[dict], ref: list[dict], labels) -> float:
    by_id = {r["contig_id"]: r for r in ref}
    return max(abs(float(r[f"{lab}_score"])
                   - float(by_id[r["contig_id"]][f"{lab}_score"]))
               for r in rows for lab in labels)


def phase_predict(tmp: Path, bundle: Path) -> int:
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.flagship import _CLASSES
    from jaeger_tpu_torch.ops import fused_conv

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
        worst = _max_score_diff(runs[name], runs["cpu_f32"], demo_labels)
        check(worst <= tol, f"demo {name} vs cpu_f32: score diff {worst}")
        same = sum(r["prediction"] == ref[r["contig_id"]]["prediction"]
                   for r in runs[name])
        print(f"predict demo {name}: {len(runs[name])} contigs, max score "
              f"diff vs CPU f32 {worst:.3f} (tol {tol}), {same}/9 calls "
              f"equal")
    return launches


def phase_int8_predict(tmp: Path, bundle: Path) -> int:
    """``predict --int8`` and ``--int8 auto`` with the flagship's int8
    bundle (phase 4 wrote it beside the bundle) and with a full_int8
    bundle of the demo made by ``utils quantize`` on the card."""
    import shutil

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.predict import BUNDLED_DEMO_MODEL
    from jaeger_tpu_torch.models.flagship import _CLASSES
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    int8_conv.launches = 0
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "flagship_int8"),
              "-m", str(bundle), "--fsize", "1505", "--batch", "2048",
              "--int8"])
    dt_full = time.perf_counter() - t0
    full8 = int8_conv.launches
    check(full8 > 0 and full8 % 6 == 0 and fused_conv.launches == 0,
          f"flagship predict --int8: {full8} int8_conv and "
          f"{fused_conv.launches} fused_conv_block launches")
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "flagship_auto"),
              "-m", str(bundle), "--fsize", "1505", "--batch", "2048",
              "--int8", "auto"])
    dt_auto = time.perf_counter() - t0
    launches = int8_conv.launches
    auto8, auto_f = launches - full8, fused_conv.launches
    check(auto8 > 0 and auto8 % 6 == 0 and auto_f % 6 == 0,
          f"flagship predict --int8 auto: {auto8} int8_conv and {auto_f} "
          f"fused_conv_block launches")
    for name in ("flagship_int8", "flagship_auto"):
        _check_tsv(_read_tsv(tmp / name / "test_contigs_default_jaeger.tsv"),
                   _CLASSES, f"predict {name}")
    print(f"predict flagship --int8 (bf16, batch 2048): {dt_full:.2f} s, "
          f"{full8} int8_conv launches; --int8 auto: {dt_auto:.2f} s, "
          f"{auto8} int8_conv + {auto_f} fused_conv_block launches")

    # the demo: utils quantize on the card, then --int8 on GPU and CPU
    demo_labels = ["chromosome", "phage", "plasmid"]
    demo = tmp / "demo"
    shutil.copytree(BUNDLED_DEMO_MODEL, demo)
    cli.main(["utils", "quantize", "-m", str(demo), "-o", f"{demo}_int8",
              "--mode", "full_int8"])
    runs = {}
    for name, extra in (("demo_int8_gpu_f32", ["--precision", "float32"]),
                        ("demo_int8_cpu_f32", ["--precision", "float32",
                                               "--device", "cpu"]),
                        ("demo_auto_gpu_bf16", ["--int8", "auto"])):
        flag = [] if "--int8" in extra else ["--int8"]
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / name), "-m",
                  str(demo)] + flag + extra)
        runs[name] = _read_tsv(tmp / name / "test_contigs_default_jaeger.tsv")
        _check_tsv(runs[name], demo_labels, f"predict {name}")
    worst = _max_score_diff(runs["demo_int8_gpu_f32"],
                            runs["demo_int8_cpu_f32"], demo_labels)
    check(worst <= 0.01, f"demo --int8 GPU f32 vs CPU f32: score diff "
                         f"{worst}")
    print(f"predict demo --int8 GPU f32: max score diff vs CPU f32 "
          f"{worst:.4f} (tol 0.01); --int8 auto GPU bf16 ran")
    return launches


# --- phase 7: host pipeline and full predict ---------------------------------

#: the synthetic assembly of phase 7: 750 contigs of 5-75 kb (30 Mb), cut
#: from 1,000 (40 Mb) to keep the phase near a minute; the terminal-repeat
#: scan, which every default run repeats, takes most of it
BIG_CONTIGS = 750
#: the pure-Python windowing subset: the same file's first 25 contigs (1 Mb)
PY_CONTIGS = 25
TANDEM = b"GATTACAGGC" * 30


def write_synthetic_fasta(path: Path, n_contigs: int, seed: int = 17) -> int:
    """A seeded assembly from numpy, lines of 80 nt: contigs of 5-75 kb
    (the length mix of a metagenome's contigs past a few kb);
    every 7th holds an N run of 10-300 nt (the split and bounded
    programs), every 5th a 40-80 nt low-complexity tract (DUST masks it),
    contig 3 a 300 nt tandem tract. The first contigs of a shorter file
    are those of a longer one. Returns the bases written."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    units = (b"A", b"CA", b"CAG", b"TTAGGG")
    total = 0
    with open(path, "wb") as fh:
        for i in range(n_contigs):
            n = int(rng.integers(5_000, 75_001))
            seq = acgt[rng.integers(0, 4, size=n)]
            if i % 7 == 1:
                at, w = int(rng.integers(0, n - 300)), int(rng.integers(10, 301))
                seq[at: at + w] = ord("N")
            if i % 5 == 2:
                unit = units[i % 4]
                at, w = int(rng.integers(0, n - 80)), int(rng.integers(40, 81))
                seq[at: at + w] = np.frombuffer(
                    (unit * (w // len(unit) + 1))[:w], np.uint8)
            if i == 3:
                seq[1000: 1000 + len(TANDEM)] = np.frombuffer(TANDEM, np.uint8)
            k = n // 80
            body = np.hstack([seq[: k * 80].reshape(k, 80),
                              np.full((k, 1), ord("\n"), np.uint8)])
            fh.write(b">ctg_%d len=%d\n" % (i, n))
            fh.write(body.tobytes())
            if n % 80:
                fh.write(seq[k * 80:].tobytes() + b"\n")
            total += n
    return total


def _windows_per_s(path: Path, workers: int) -> tuple[float, list]:
    """The port's ``window_batches`` as ``predict`` calls it at the
    flagship's 1505 nt (stride 1500, DUST on): windows/s, batches."""
    from jaeger_tpu_torch.seqops.windows import window_batches

    t0 = time.perf_counter()
    batches = list(window_batches(str(path), fragsize=1505, stride=1500,
                                  min_len=1505, workers=workers))
    dt = time.perf_counter() - t0
    return sum(len(b) for b in batches) / dt, batches


@contextlib.contextmanager
def engine_host_timers():
    """Host seconds and calls of the engine's pack, upload (pinned copy
    and enqueue) and plan, accumulated while the block runs."""
    from jaeger_tpu_torch.infer import engine as eng_mod

    acc = {"pack": [0.0, 0], "upload": [0.0, 0], "plan": [0.0, 0]}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[name][0] += time.perf_counter() - t0
                acc[name][1] += 1
        return wrapper

    cls = eng_mod.InferenceEngine
    saved = eng_mod.pack_bases, cls._to_device, cls._plan_batch
    eng_mod.pack_bases = timed("pack", saved[0])
    cls._to_device = timed("upload", saved[1])
    cls._plan_batch = timed("plan", saved[2])
    try:
        yield acc
    finally:
        eng_mod.pack_bases, cls._to_device, cls._plan_batch = saved


def device_busy_share(trace: Path) -> tuple[float, float, int]:
    """From a ``predict --profile`` Chrome trace: the share of the
    ``predict.inference`` range during which a kernel, copy or memset ran
    on the card, the kernels' share alone, and the kernel count."""
    events = json.loads(trace.read_text())["traceEvents"]
    rng_ev = [e for e in events if e.get("name") == "predict.inference"
              and e.get("cat") == "user_annotation"]
    check(len(rng_ev) == 1, f"{trace}: {len(rng_ev)} predict.inference "
                            f"ranges")
    lo = float(rng_ev[0]["ts"])
    hi = lo + float(rng_ev[0]["dur"])

    def union(cats) -> tuple[float, int]:
        spans = sorted((max(float(e["ts"]), lo),
                        min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                       for e in events if e.get("cat") in cats
                       and e.get("ph") == "X")
        busy, end, n = 0.0, lo, 0
        for a, b in spans:
            if b <= a:
                continue
            n += 1
            if a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy, n

    busy, _ = union({"kernel", "gpu_memcpy", "gpu_memset"})
    kern, n_kernels = union({"kernel"})
    return busy / (hi - lo), kern / (hi - lo), n_kernels


def _cprofile_top(fn, top: int = 10) -> str:
    """``fn()`` under cProfile; the ``top`` functions by own time. From
    Python 3.12 cProfile records every thread, so a worker pool's calls
    sum over its threads."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    try:
        fn()
    finally:
        prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    lines = out.getvalue().splitlines()
    start = next(i for i, ln in enumerate(lines) if "ncalls" in ln)
    return "\n".join(lines[start: start + top + 1])


def _stages_fasta(path: Path) -> None:
    """A small FASTA for the four stages: a 105 kb host contig holding the
    first test contig (the prophage stage's region), the third test
    contig, a contig with the tandem tract, a 3 kb contig."""
    import numpy as np

    from jaeger_tpu_torch.seqops.fasta import read_fasta

    recs = list(read_fasta(str(FASTA)))
    rng = np.random.default_rng(5)

    def dna(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    host = dna(30_000) + recs[0][1] + dna(30_000)
    tandem = dna(2000) + TANDEM.decode() + dna(2000)
    path.write_text(f">host,1\n{host}\n>{recs[2][0]}\n{recs[2][1]}\n"
                    f">tandem\n{tandem}\n>short\n{dna(3000)}\n")


def _stage_runs(tmp: Path, bundle: Path) -> dict:
    """``--mask-tandem``, ``--prophage``, ``--refine`` and ``--profile`` on
    a small FASTA (``--plot-type none``: the card's machine may lack
    matplotlib), each checked for its files; the fused-conv launch count
    is reset before and read after each run."""
    import numpy as np

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.postprocess import refinement
    from jaeger_tpu_torch.seqops.fasta import read_fasta

    fasta = tmp / "stages.fasta"
    _stages_fasta(fasta)
    flag = ["-m", str(bundle), "--fsize", "1505", "--batch", "2048"]
    launches = {}

    def run(name, args):
        fused_conv.launches = 0
        t0 = time.perf_counter()
        cli.main(["predict", "-i", str(fasta), "-o", str(tmp / name),
                  *args])
        launches[name] = fused_conv.launches
        print(f"stage {name}: {time.perf_counter() - t0:.2f} s, "
              f"{launches[name]} fused_conv_block launches")
        return tmp / name

    out = run("mask_tandem", [*flag, "--mask-tandem"])
    masked = dict(read_fasta(str(out / "stages_tandem_masked.fasta")))
    check(set(masked["tandem"][2050:2250]) == {"N"}
          and "N" not in masked["tandem"][:1900],
          "--mask-tandem: the tandem tract is not masked")
    check((out / "stages_default_jaeger.tsv").exists(),
          "--mask-tandem wrote no TSV")

    # the demo model's phage track reaches 0.3 in the host contig's phage
    # insert; the region must equal a CPU float32 run's
    pro_args = ["--fsize", "500", "--stride", "500", "-p", "--lc", "20000",
                "-s", "0.3", "--plot-type", "none", "--precision",
                "float32"]
    out = run("prophage", pro_args)
    cpu = run("prophage_cpu", [*pro_args, "--device", "cpu"])
    rep = "stages_prophages/prophages_jaeger.tsv"
    rows, ref = _read_tsv(out / rep), _read_tsv(cpu / rep)
    regions = [(r["contig_id"], r["raw_start"], r["raw_end"]) for r in rows]
    check(len(rows) >= 1 and regions == [
        (r["contig_id"], r["raw_start"], r["raw_end"]) for r in ref],
        f"--prophage: regions {regions} on the card, "
        f"{[(r['contig_id'], r['raw_start'], r['raw_end']) for r in ref]} "
        f"on the CPU")
    check((out / "stages_prophages" / "plots").is_dir(),
          "--prophage wrote no plots directory")

    # the seeded flagship's logits lie within 0.01 of 0 and its windows'
    # top-two margins near 0.002: taus that pass most windows, not all
    taus_rng = np.random.default_rng(23)
    taus = {k: {"logit": float(taus_rng.uniform(-3.0, -2.0)),
                "margin": float(taus_rng.uniform(0.0, 0.0015)), "n": 100}
            for k in refinement.CLASSES}
    refinement.save_refinement(
        taus, bundle / "jaeger_tpu_flagship_refine.yaml",
        jaeger_model="jaeger_tpu_flagship", quantile=0.05)
    out = run("refine", [*flag, "--refine"])
    rows = _read_tsv(out / "stages_default_jaeger.tsv")
    check(all(c in rows[0] for c in ("contig_call", "contig_top_logit",
                                     "contig_margin", "n_windows_used")),
          f"--refine: no refined columns in {sorted(rows[0])}")
    calls = sum(bool(r["contig_call"]) for r in rows)
    check(calls >= 1, "--refine: no contig got a refined call")
    (bundle / "jaeger_tpu_flagship_refine.yaml").unlink()

    out = run("profile", [*flag, "--profile"])
    busy, _, n_k = device_busy_share(out / "profile" / "predict_trace.json")
    check(n_k > 0, "--profile: no kernel in the trace")
    for name in ("mask_tandem", "prophage", "refine", "profile"):
        check(launches[name] > 0, f"stage {name}: no fused_conv_block "
                                  f"launch")
    print(f"stages: --mask-tandem masked the tract; --prophage "
          f"{len(regions)} region(s) equal to the CPU's; --refine "
          f"{calls}/{len(rows)} contigs called; --profile {n_k} kernels "
          f"in the trace")
    return launches


def phase_host_pipeline(tmp: Path, bundle: Path, card: str) -> dict:
    """Phase 7: the native host pipeline at scale and ``predict`` complete
    (see the module docstring)."""
    import os

    import numpy as np
    import torch

    from jaeger_tpu_torch import cli, native
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.postprocess.termini import scan_for_terminal_repeats

    check(os.environ.get("JAEGER_TPU_TORCH_NATIVE", "1") != "0",
          "JAEGER_TPU_TORCH_NATIVE=0 switches the native pipeline off")
    check(native.available(), "the port's native host library is not live")
    lib = native.library_path()
    check(lib is not None and (ROOT / "build") in lib.resolve().parents,
          f"the native library {lib} is not the port's own under build/")
    print(f"native host library: {lib.relative_to(ROOT)}")

    big, small = tmp / "assembly.fasta", tmp / "subset.fasta"
    t0 = time.perf_counter()
    n_bases = write_synthetic_fasta(big, BIG_CONTIGS)
    n_small = write_synthetic_fasta(small, PY_CONTIGS)
    print(f"synthetic assembly: {BIG_CONTIGS} contigs, {n_bases / 1e6:.1f} "
          f"Mb ({time.perf_counter() - t0:.1f} s to write); subset "
          f"{PY_CONTIGS} contigs, {n_small / 1e6:.2f} Mb")

    res = {"card": card, "assembly_mb": n_bases / 1e6, "native": {}}
    n_cpu = os.cpu_count() or 1
    for w in sorted({1, 4, n_cpu}):
        rate, batches = _windows_per_s(big, w)
        res["native"][w] = rate
        print(f"host windowing, native, {w} workers: {rate:.0f} windows/s")
    n_windows = sum(len(b) for b in batches)
    first = batches[0]
    del batches
    nat_small = _windows_per_s(small, 4)[1]
    os.environ["JAEGER_TPU_TORCH_NATIVE"] = "0"
    try:
        res["python"], py_small = _windows_per_s(small, 4)
    finally:
        del os.environ["JAEGER_TPU_TORCH_NATIVE"]
    fields = ("bases", "length", "contig", "start", "contig_end", "ordinal",
              "seqlen", "g", "c", "a", "t", "gc_skew")
    check(len(py_small) == len(nat_small) and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        and a.headers == b.headers
        for a, b in zip(py_small, nat_small) for f in fields),
        "native and Python windows differ on the subset")
    print(f"host windowing, pure Python, 4 workers: {res['python']:.0f} "
          f"windows/s on the {n_small / 1e6:.2f} Mb subset (equal to the "
          f"native windows)")

    t0 = time.perf_counter()
    repeats = scan_for_terminal_repeats(str(big), fsize=1505, workers=4)
    res["scan_s"] = time.perf_counter() - t0
    print(f"terminal-repeat scan, native, 4 workers: {res['scan_s']:.2f} s "
          f"for {len(repeats)} contigs")

    # the forward of the engine's first batch of this file, on the card
    model, _, _ = load_model(bundle, dtype=torch.bfloat16, device="cuda")
    eng = InferenceEngine(model, batch_size=2048, device="cuda")
    b, ln = first.bases[:2048], first.length[:2048]
    dense, split, cut = eng._plan_batch(b, ln, b.shape[0])
    if split is not None:
        # the base forward of a split batch, as the engine runs it
        _, _, b, ln = eng._gather_masked(b, ln, *split)
        dense = cut is None
    prog = dict(assume_dense=dense, mask_layers=None if dense else cut)
    tb, tl = torch.from_numpy(b).cuda(), torch.from_numpy(ln).cuda()
    with torch.inference_mode():
        res["forward_ms"] = cuda_ms(lambda: model(tb, tl, **prog), iters=5)
    del model, eng, tb, tl

    # predict end to end, default stages: counts reset just before, read
    # just after
    args = ["-m", str(bundle), "--fsize", "1505", "--batch", "2048"]
    fused_conv.launches = 0
    with engine_host_timers() as acc:
        t0 = time.perf_counter()
        cli.main(["predict", "-i", str(big), "-o", str(tmp / "scale"),
                  *args])
        res["predict_s"] = time.perf_counter() - t0
    res["launches"] = fused_conv.launches
    check(res["launches"] > 0 and res["launches"] % 6 == 0,
          f"predict at scale: {res['launches']} fused_conv_block launches")
    rows = _read_tsv(tmp / "scale" / "assembly_default_jaeger.tsv")
    check(len(rows) >= 0.9 * BIG_CONTIGS and all(
        math.isfinite(float(r["phage_score"])) for r in rows),
        f"predict at scale: {len(rows)} rows")
    res["windows_per_s"] = n_windows / res["predict_s"]
    n_batches = acc["plan"][1]
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(big), "-o", str(tmp / "scale_no_termini"),
              *args, "--no-termini"])
    res["no_termini_s"] = time.perf_counter() - t0
    host = {k: v[0] * 1e3 / max(n_batches, 1) for k, v in acc.items()}
    res["host_ms_per_batch"] = host
    print(f"predict at scale: {n_windows} windows of {BIG_CONTIGS} contigs "
          f"in {res['predict_s']:.2f} s = {res['windows_per_s']:.0f} "
          f"windows/s (the dense engine: 22916 windows/s, PERF.md), "
          f"{res['launches']} fused_conv_block launches, {len(rows)} rows; "
          f"with --no-termini {res['no_termini_s']:.2f} s = "
          f"{n_windows / res['no_termini_s']:.0f} windows/s")
    print(f"engine host time per batch of 2048 ({n_batches} batches): pack "
          f"{host['pack']:.2f} ms, upload {host['upload']:.2f} ms, plan "
          f"{host['plan']:.2f} ms, against a {res['forward_ms']:.2f} ms "
          f"forward of this file's first batch")

    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(big), "-o", str(tmp / "scale_profile"),
              *args, "--profile"])
    res["profiled_predict_s"] = time.perf_counter() - t0
    busy, kern, n_k = device_busy_share(
        tmp / "scale_profile" / "profile" / "predict_trace.json")
    res["device_busy"], res["kernel_busy"] = busy, kern
    print(f"predict --profile at scale: {res['profiled_predict_s']:.2f} s; "
          f"the card busy {busy:.1%} of the inference loop (kernels "
          f"{kern:.1%}, {n_k} kernels)")
    # the scan's own profile is one native call; what is left besides it
    top = _cprofile_top(lambda: cli.main(
        ["predict", "-i", str(big), "-o", str(tmp / "scale_cprofile"),
         *args, "--no-termini"]))
    print("predict --no-termini at scale, cProfile (every thread), top 10 "
          "by own time:\n" + top)

    res["stage_launches"] = _stage_runs(tmp, bundle)
    return res


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
        if "--backward" in argv:
            phase_train_kernel(card)
            if "--sweep" in argv:
                phase_train_sweep(card)
            print(f"backward run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        if "--host" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                host = phase_host_pipeline(
                    Path(tmp), flagship_bundle(Path(tmp)), card)
            print(json.dumps({"host_pipeline": host}))
            print(f"host run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        kern = phase_kernel(card)
        kern8 = phase_int8_kernel(card)
        kern_train = phase_train_kernel(card)
        if "--sweep" in argv:
            phase_sweep(card)
            phase_int8_sweep(card)
            phase_train_sweep(card)
        if quick:
            print(f"quick run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        profile = "--profile" in argv
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            rates = phase_flagship(profile)
            bundle = flagship_bundle(Path(tmp))
            rates8 = phase_int8_flagship(bundle, profile)
            launches = phase_predict(Path(tmp), bundle)
            launches8 = phase_int8_predict(Path(tmp), bundle)
            step_f32 = phase_train_step_f32()
            train = phase_train_flagship(Path(tmp), card)
            phase_train_predict(Path(tmp), train["bundle"])
            host = phase_host_pipeline(Path(tmp), bundle, card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    summary = {"card": card, "flagship_windows_per_s": rates,
               "flagship_int8_windows_per_s": rates8,
               "fused_conv_conv2_form": kern["conv2"],
               "fused_conv_bias_only_form": kern["bias_only"],
               "fused_conv_data_gradient": kern_train["dgrad"],
               "int8_conv_conv2_form": kern8["conv2"],
               "int8_conv_bias_only_form": kern8["bias_only"],
               "int8_conv_requant_pallas_shape": kern8["requant"],
               "train_step_f32_worst_grad_err": step_f32,
               "train_flagship": {k: v for k, v in train.items()
                                  if k != "bundle"},
               "conv_epilogue_bwd_conv1_form": {
                   k: kern_train["conv_epilogue_bwd"][k]
                   for k in ("conv1_ms", "conv1_bound_ms")},
               "conv_wgrad_plan": kern_train["conv_wgrad"]["plan"],
               "host_pipeline": host}
    print(json.dumps(summary))
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(card)

    def entry(name, route, source, replaces, n, k, **extra):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                "bound_share": k["bound_ms"] / k["ms"], **extra}

    tl = train["launches"]
    print(json.dumps({"kernels": [
        # predict's main path; train launches it for the forward, the
        # recomputed DYT input and the data gradient
        entry("fused_conv_block", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_block.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", launches, kern,
              train_launches=tl["fused_conv_block"],
              predict_at_scale_launches=host["launches"]),
        entry("int8_conv", "cuda", "jaeger_tpu_torch/csrc/int8_conv.cu",
              "experiments/pallas_int8_conv.py:67", launches8, kern8),
        # train's main path: the backward of the fused conv block
        entry("conv_wgrad", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_wgrad.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", tl["conv_wgrad"],
              kern_train["conv_wgrad"],
              host_us=kern_train["conv_wgrad"]["host_us"]),
        entry("conv_epilogue_bwd", "cuda",
              "jaeger_tpu_torch/csrc/conv_epilogue_bwd.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", tl["conv_epilogue_bwd"],
              kern_train["conv_epilogue_bwd"],
              host_us=kern_train["conv_epilogue_bwd"]["host_us"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
