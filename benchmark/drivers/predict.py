"""The ``predict`` flow: an assembly through windowing, the engine and the
device reduce, as ``commands/predict.py::run_core`` runs them with its
stages off (no terminal-repeat scan, no TSV: those run once per file).

Set-up writes the assembly from the seed, builds the model with the seeded
weights in the configuration's precision, and warms the shapes the mix
reaches: the dense program at the batch, the split buckets of 1/16 and
1/8 of it, the reduce, and the native windowing. The window is one call
of ``InferenceEngine.predict_batches_reduced`` fed by the native
``window_batches``: pass after pass over the assembly, each pass's contig
indices offset so that no pass adds to another's contigs, until
``seconds`` have passed; the engine then drains what is in flight. The
rate is every window whose per-contig results reached the host over the
whole window.

The window keeps the outputs of each forward it runs (references to the
device tensors the engine returns, no copy). Afterwards the program is
freed, a sample of the contigs served whole (the longest among them) is
drawn from the seed, their windows' logits are found among the kept
outputs by the windows' bases, and the reference recomputes those windows
from the assembly's bases and the seeded weights, in float32 and rounded
to the configuration's precision;
:func:`benchmark.reference.judge.judge_predict` compares.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import time

import numpy as np
import torch

from benchmark.harness.flops import forward_flops
from benchmark.harness.program import build_program
from benchmark.harness.spans import Spans, patched
from benchmark.harness.trace import Tracer
from benchmark.harness.weights import seeded_weights
from benchmark.reference.judge import judge_predict
from benchmark.reference.model import Reference, crop_nt
from benchmark.reference.windows import contig_windows, six_frames, window_starts

SPAN_NAMES = {"windowing", "engine.plan", "engine.pack", "engine.upload",
              "engine.forward", "engine.reduce", "engine.accumulate"}
#: the host's time in the engine outside those spans: mostly the wait for
#: each batch's outputs (the drain)
OUTSIDE = "engine.drain"
E2E = "predict_windows_per_s"


def _warm_batch(bs: int, width: int, masked: int, rng):
    from jaeger_tpu_torch.seqops.windows import WindowBatch

    bases = rng.integers(0, 4, size=(bs, width)).astype(np.uint8)
    bases[:masked, width // 3: width // 3 + 20] = 4
    zeros = np.zeros(bs, np.int32)
    return WindowBatch(bases=bases, length=np.full(bs, width, np.int32),
                       contig=np.arange(bs, dtype=np.int32), start=zeros,
                       contig_end=np.ones(bs, np.int8), ordinal=zeros,
                       seqlen=np.full(bs, width, np.int32), g=zeros, c=zeros,
                       a=zeros, t=zeros, gc_skew=np.zeros(bs, np.float32),
                       headers=[f"w{i}" for i in range(bs)])


def run(cell, seed: int, seconds: float, trace: bool, device, workdir,
        t_start: float) -> dict:
    from jaeger_tpu_torch.infer import engine as eng_mod
    from jaeger_tpu_torch.ops.reduce import ContigAccumulator
    from jaeger_tpu_torch.seqops.windows import window_batches

    s = cell.settings
    model_cfg = cell.config["model"]
    fsize, stride, bs = int(s["fsize"]), int(s["stride"]), int(s["batch"])
    workers = int(s.get("workers", 4))
    classes = int(model_cfg["classifier_out_dim"])
    data = cell.generator().make(cell.traffic["params"], seed, workdir)
    seqs = data["seqs"]
    n_contigs = len(seqs)

    weights = seeded_weights(model_cfg, seed, device)
    model = build_program(model_cfg, weights, s["precision"], device)
    engine = eng_mod.InferenceEngine(model, batch_size=bs, device=device,
                                     output_keys=("prediction", "reliability"))

    def batches(path):
        return window_batches(path, fragsize=fsize, stride=stride, min_len=fsize,
                              dustmask=True, workers=workers)

    # warm-up: the native windowing, then each program the mix reaches
    warm = batches(data["path"])
    next(warm)
    warm.close()
    rng = np.random.default_rng(seed)
    engine.predict_batches_reduced(
        [_warm_batch(bs, fsize, m, rng)
         for m in (0, bs // 16 * 15 // 16, bs // 8 * 15 // 16)],
        num_classes=classes, with_reliability=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    engine.program_counts.clear()
    setup_s = time.perf_counter() - t_start

    spans = Spans(trace)
    tracer = Tracer(trace, SPAN_NAMES, OUTSIDE)
    trace_from, trace_batches = s.get("trace_batches", [6, 6])
    traced, served, current_pass = {}, [0], [0]
    done: list[np.ndarray] = []
    t0 = time.perf_counter()

    def feed():
        for p in itertools.count():
            it = batches(data["path"])
            try:
                while time.perf_counter() - t0 < seconds:
                    with spans.span("windowing"):
                        batch = next(it, None)
                    if batch is None:
                        break
                    batch = dataclasses.replace(
                        batch, contig=batch.contig + p * n_contigs)
                    current_pass[0] = p
                    done.append(batch.contig[batch.contig_end == 1])
                    served[0] += 1
                    if served[0] == trace_from and trace:
                        tracer.start()
                        traced["before"] = dict(engine.program_counts)
                    elif served[0] == trace_from + trace_batches and tracer.active:
                        tracer.stop()
                        traced["after"] = dict(engine.program_counts)
                    yield batch
                else:
                    return
            finally:
                it.close()

    cls = eng_mod.InferenceEngine
    forward = cls._forward
    captured: list = []

    def keep(self, bases, lengths, dense=False, mask_cut=None):
        # the timed forward's own outputs, kept (not copied) for the check
        out = forward(self, bases, lengths, dense, mask_cut)
        captured.append((current_pass[0], bases, lengths, out))
        return out

    wraps = [(cls, "_forward", spans.wrap("engine.forward", keep)),
             (eng_mod, "pack_bases", spans.wrap("engine.pack", eng_mod.pack_bases)),
             (eng_mod, "contig_partials",
              spans.wrap("engine.reduce", eng_mod.contig_partials)),
             (cls, "_to_device", spans.wrap("engine.upload", cls._to_device)),
             (cls, "_plan_batch", spans.wrap("engine.plan", cls._plan_batch)),
             (ContigAccumulator, "add_batch",
              spans.wrap("engine.accumulate", ContigAccumulator.add_batch))]
    with patched(wraps):
        results, kept = engine.predict_batches_reduced(
            feed(), num_classes=classes, with_reliability=True)
    if tracer.active:
        tracer.stop()
        traced["after"] = dict(engine.program_counts)
    window_s = time.perf_counter() - t0
    tracer.finish()
    windows = sum(len(b) for b in kept)
    programs = dict(engine.program_counts)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del engine, model, kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on a sample of the contigs served whole
    finished = np.unique(np.concatenate(done)) if done else np.zeros(0, np.int64)
    expected = {int(g): len(window_starts(len(seqs[g % n_contigs]), fsize, stride,
                                          fsize))
                for g in finished}
    sample = _sample(finished, seqs, n_contigs, seed, int(s.get("check_windows", 1024)),
                     fsize, stride)
    contigs = {g: contig_windows(seqs[g % n_contigs], fsize, stride, fsize)
               for g in sample}
    prog = _timed_windows(captured, contigs, n_contigs)
    del captured
    ref = reference_windows(model_cfg, weights, contigs, device)
    rounded = reference_windows(model_cfg, weights, contigs, device,
                                rounding=s["precision"])
    numbers = judge_predict(results, expected, ref, prog, rounded)
    before = traced.get("before", {})
    traced_forwards = {k: v - before.get(k, 0)
                       for k, v in traced.get("after", {}).items()
                       if v - before.get(k, 0)}
    return {
        "setup_s": setup_s, "window_s": window_s,
        "e2e": {E2E: windows / window_s},
        "numbers": numbers, "attempted": len(expected),
        "memory_peak_bytes": peak,
        "counters": {"program_counts": {str(k): v for k, v in programs.items()},
                     "contigs_finished": len(expected), "windows": windows,
                     "sampled_contigs": len(sample),
                     "sampled_windows": sum(len(w[1]) for w in contigs.values()),
                     "host_spans": spans.totals()},
        "context": {"windows": windows, "window_s": window_s, "spans": spans,
                    "trace": tracer.summary, "traced_forwards": traced_forwards,
                    "model_cfg": model_cfg, "settings": s,
                    "flops_per_window": forward_flops(model_cfg)},
    }


def _sample(finished, seqs, n_contigs, seed, target, fsize, stride) -> list[int]:
    """Contigs drawn from the seed until ``target`` windows, the longest
    served contig first."""
    if finished.size == 0:
        return []
    lengths = np.array([len(seqs[g % n_contigs]) for g in finished])
    order = np.random.default_rng(seed + 1).permutation(finished.size)
    picked = [int(finished[int(lengths.argmax())])]
    total = len(window_starts(int(lengths.max()), fsize, stride, fsize))
    for i in order:
        g = int(finished[i])
        if total >= target:
            break
        if g not in picked:
            picked.append(g)
            total += len(window_starts(len(seqs[g % n_contigs]), fsize, stride, fsize))
    return picked


def _timed_windows(captured, contigs: dict, n_contigs: int) -> dict:
    """Each sampled contig's window logits ``(z, r)`` as the timed forward
    produced them, found by the windows' bases (soft-masked bases folded,
    as the models' ``masking: false`` reads them) and lengths in the pass
    that served the contig (a padding row of N has length 0)."""
    where: dict = {}
    for g, (wins, lengths) in contigs.items():
        for i, row in enumerate(wins):
            key = (g // n_contigs, int(lengths[i]), row.tobytes())
            where.setdefault(key, []).append((g, i))
    z = {g: [None] * len(w[1]) for g, w in contigs.items()}
    r = {g: [None] * len(w[1]) for g, w in contigs.items()}
    passes = {g // n_contigs for g in contigs}
    for p, bases, lengths, out in captured:
        if p not in passes:
            continue
        folded = np.where(bases >= 5, bases - 5, bases)
        hits = [(i, where[key]) for i, row in enumerate(folded)
                if (key := (p, int(lengths[i]), row.tobytes())) in where]
        if not hits:
            continue
        rows = torch.tensor([i for i, _ in hits])
        zp = out["prediction"][rows.to(out["prediction"].device)].cpu().numpy()
        rp = (out["reliability"][rows.to(out["reliability"].device)].cpu().numpy()
              if "reliability" in out else None)
        for j, (_, owners) in enumerate(hits):
            for g, i in owners:
                z[g][i] = zp[j]
                r[g][i] = None if rp is None else rp[j]
    prog = {}
    for g in contigs:
        if any(v is None for v in z[g]):
            prog[g] = None
            continue
        prog[g] = (np.stack(z[g]),
                   None if r[g][0] is None else np.stack(r[g]))
    return prog


def reference_windows(model_cfg, weights, contigs: dict, device,
                      block: int = 256, rounding: str = "float32") -> dict:
    """The reference's class and reliability logits ``(z, r)`` of each
    contig's windows ``contigs[g] = (windows, lengths)``, rounded as
    ``rounding`` says."""
    crop = crop_nt(model_cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(model_cfg, weights, rounding=rounding)
    order = list(contigs)
    if not order:
        return {}
    wins = np.concatenate([contigs[g][0] for g in order])
    lens = np.concatenate([contigs[g][1] for g in order])
    zs, rs = [], []
    with torch.no_grad():
        for a in range(0, len(lens), block):
            tok = six_frames(torch.from_numpy(wins[a:a + block]).to(device),
                             torch.from_numpy(lens[a:a + block]).to(device), crop)
            out = ref.forward(tok)
            zs.append(out["prediction"].float().cpu().numpy())
            if "reliability" in out:
                rs.append(out["reliability"].float().cpu().numpy())
    z = np.concatenate(zs)
    r = np.concatenate(rs) if rs else None
    out, at = {}, 0
    for g in order:
        n = len(contigs[g][1])
        out[g] = (z[at:at + n], None if r is None else r[at:at + n])
        at += n
    return out
