"""The ``train`` flow: the classifier branch's step loop of
``commands/train.py::_run_branch`` (``make_dispatching_train_step`` over
``batches_from_csv``, the non-finite-loss check every 50 steps), without
its per-epoch validation and checkpoints.

Set-up writes the CSV from the seed, builds the model with the seeded
weights, the configuration's optimizer and loss, and one step function,
then drives that same step through its first ``check_steps`` steps on the
window's own feed (rows that all differ) and the step's generator, seeded
with the run's seed: they warm it, and they are the steps the reference
follows, drawing its dropout masks from a generator seeded alike. The program's loss of each, its first
gradient as the optimizer got it (Adam's first moment after one step over
``1 - beta_1``) and its parameters after the last are kept. The window
then runs step after step for ``seconds`` and ends after a final
``synchronize``; the rate is every window of every step over the window.

Afterwards the program is freed and :func:`benchmark.reference.train.
train_steps` repeats the checked steps from the seeded weights on the same
host batches, in float32 and rounded to the configuration's precision;
:func:`benchmark.reference.judge.judge_train` compares.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness.flops import forward_flops
from benchmark.harness.program import build_program
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Tracer
from benchmark.harness.weights import seeded_weights
from benchmark.reference.judge import judge_train
from benchmark.reference.model import crop_nt
from benchmark.reference.train import train_steps

SPAN_NAMES = {"train.data", "train.step"}
#: the host's time in the step loop outside those spans
OUTSIDE = "train.loop"
E2E = "train_windows_per_s"


def _host(tree: dict) -> dict:
    return {k.replace("/", "."): v.detach().float().cpu().numpy().copy()
            for k, v in tree.items()}


def _reference_run(run: dict) -> dict:
    return {"losses": run["losses"], "first_grads": _host(run["first_grads"]),
            "params": _host(run["params"])}


def run(cell, seed: int, seconds: float, trace: bool, device, workdir,
        t_start: float) -> dict:
    from jaeger_tpu_torch.commands.train import _label_map
    from jaeger_tpu_torch.train import data as data_lib
    from jaeger_tpu_torch.train.loop import (StepConfig, TrainState,
                                             make_dispatching_train_step)
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    s = cell.settings
    model_cfg = cell.config["model"]
    train_cfg = cell.config["training"]
    bs = int(s["batch"])
    check = int(s.get("check_steps", 3))
    classes = int(model_cfg["classifier_out_dim"])
    crop = crop_nt(model_cfg)
    data = cell.generator().make(cell.traffic["params"], seed, workdir, crop, classes)

    weights = seeded_weights(model_cfg, seed, device)
    initial = _host(weights)
    model = build_program(model_cfg, weights, s["precision"], device).train()
    tx = make_optimizer(train_cfg.get("optimizer", "adam"),
                        train_cfg.get("optimizer_params", {}),
                        accumulation_steps=int(train_cfg.get("accumulation_steps", 1)
                                               or 1))
    state = TrainState.create(model, tx)
    step_cfg = StepConfig(
        loss_name=train_cfg.get("loss_classifier", "categorical_crossentropy"),
        loss_params=train_cfg.get("loss_params_classifier", {}),
        reg_specs=tuple(model.regularizer_specs()), heads=("prediction",))
    step = make_dispatching_train_step(model, step_cfg, device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    feed = data_lib.batches_from_csv(
        [data["path"]], batch_size=bs, crop_nt=crop, num_classes=classes,
        shuffle_buffer=int(s.get("shuffle_buffer", 1024)), seed=int(seed),
        label_map=_label_map(model_cfg.get("string_processor", {})), repeat=True)

    # the checked steps, through the window's own step and feed
    b1 = float(train_cfg.get("optimizer_params", {}).get("beta_1", 0.9))
    checked, losses, first_grads = [], [], None
    for i in range(check):
        batch = next(feed)
        checked.append(batch)
        state, metrics = step(state, batch, generator)
        losses.append(float(metrics["loss"]))
        if i == 0:
            first_grads = _host({k: v / (1.0 - b1)
                                 for k, v in state.opt_state["mu"].items()})
    after = _host(state.params)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    spans = Spans(trace)
    tracer = Tracer(trace, SPAN_NAMES, OUTSIDE)
    trace_from, trace_steps = s.get("trace_steps", [10, 8])
    steps, metrics, traced = 0, None, [0, 0]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace and steps == trace_from:
            tracer.start()
            traced[0] = steps
        elif tracer.active and steps == trace_from + trace_steps:
            tracer.stop()
            traced[1] = steps
        with spans.span("train.data"):
            batch = next(feed)
        with spans.span("train.step"):
            state, metrics = step(state, batch, generator)
        if steps % 50 == 0 and not np.isfinite(float(metrics["loss"])):
            raise FloatingPointError(f"non-finite loss at step {steps}")
        steps += 1
    if tracer.active:
        tracer.stop()
        traced[1] = steps
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.finish()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    programs = dict(step.program_counts)
    del state, model, step, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref, rounded = (
        train_steps(model_cfg, train_cfg, weights, checked, device, seed,
                    rounding=rounding)
        for rounding in ("float32", s["precision"]))
    numbers, details = judge_train(
        {"losses": losses, "first_grads": first_grads, "params": after},
        _reference_run(ref), _reference_run(rounded), initial)
    return {
        "setup_s": setup_s, "window_s": window_s,
        "e2e": {E2E: steps * bs / window_s},
        "numbers": numbers, "attempted": steps + check,
        "memory_peak_bytes": peak,
        "counters": {"program_counts": programs, "steps": steps,
                     "checked_losses": losses, "check_details": details,
                     "host_spans": spans.totals()},
        "context": {"windows": steps * bs, "window_s": window_s, "steps": steps,
                    "spans": spans, "trace": tracer.summary,
                    "traced_steps": traced[1] - traced[0], "batch": bs,
                    "model_cfg": model_cfg, "settings": s,
                    "flops_per_window": forward_flops(model_cfg, heads=("prediction",))},
    }
