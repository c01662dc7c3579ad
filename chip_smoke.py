#!/usr/bin/env python3
"""Smoke run of jaeger_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout on a machine with CUDA:

    python3 chip_smoke.py            # every phase; exits 0 when all pass
    python3 chip_smoke.py --quick    # phases 1-3 only (build, kernel checks)
    python3 chip_smoke.py --profile  # also: device time by kernel (torch
                                     # profiler) of each flagship forward
    python3 chip_smoke.py --sweep    # also: both kernels under other
                                     # launch plans and with fewer taps

Phases, each of which fails the run:

1. device: torch version, the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/fused_conv_block.cu and csrc/int8_conv.cu for
   sm_90a, one nvcc per source, started together; ptxas' registers, stack
   and spills of each instance of the two wgmma kernels;
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
   are checked, the demo's against a CPU float32 run (float and int8).

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

KERNEL_SOURCES = ("fused_conv_block", "int8_conv")


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
                         ("int8_conv", "int8_wgmma")):
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
            out.append(f"{kernel}<{_template_args(entry.split(kernel, 1)[1])}>"
                       f": {line.split(':', 1)[-1].strip()}")
    return out


def _template_args(mangled: str) -> str:
    """'bf16, 128, 64' from the Itanium mangling of a kernel's template
    arguments (``I13__nv_bfloat16Li128ELi64EEEv...``, ``IaLi16ELi32E...``)."""
    args = mangled.split("EEv", 1)[0] + "E"
    types = {"a": "int8", "13__nv_bfloat16": "bf16", "f": "f32"}
    m = re.match(r"I(a|f|13__nv_bfloat16)?", args)
    head = [types[m.group(1)]] if m and m.group(1) else []
    return ", ".join(head + re.findall(r"Li(\d+)E", args))


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
        kern = phase_kernel(card)
        kern8 = phase_int8_kernel(card)
        if "--sweep" in argv:
            phase_sweep(card)
            phase_int8_sweep(card)
        if quick:
            print(f"quick run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        profile = "--profile" in argv
        rates = phase_flagship(profile)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            bundle = flagship_bundle(Path(tmp))
            rates8 = phase_int8_flagship(bundle, profile)
            launches = phase_predict(Path(tmp), bundle)
            launches8 = phase_int8_predict(Path(tmp), bundle)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"flagship_windows_per_s": rates,
                      "flagship_int8_windows_per_s": rates8, "card": card,
                      "fused_conv_conv2_form": kern["conv2"],
                      "fused_conv_bias_only_form": kern["bias_only"],
                      "int8_conv_conv2_form": kern8["conv2"],
                      "int8_conv_bias_only_form": kern8["bias_only"],
                      "int8_conv_requant_pallas_shape": kern8["requant"]}))
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(card)

    def entry(name, source, replaces, n, k):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                "bound_share": k["bound_ms"] / k["ms"]}

    print(json.dumps({"kernels": [
        entry("fused_conv_block", "jaeger_tpu_torch/csrc/fused_conv_block.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", launches, kern),
        entry("int8_conv", "jaeger_tpu_torch/csrc/int8_conv.cu",
              "experiments/pallas_int8_conv.py:67", launches8, kern8),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
