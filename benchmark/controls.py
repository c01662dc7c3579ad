#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: sound runs, the control and
the planted faults, per seed.

    python3 benchmark/controls.py --workload <cell> --plant <plant> \\
        --seeds <n,n,...> --seconds <s>

prints one JSON line per seed with the numbers compared (no limit is
applied). Plants:

* ``none``: the program as it is (the lower readings);
* ``control``: the reference computed one precision below the
  configuration's in the program's place (every product's operands,
  result and gradients in float8 e4m3, the float32 heads' in bf16),
  judged as the program is;
* ``int8``: ``predict`` through the program's own int8 path (the model
  quantized by ``utils quantize --mode full_int8``'s code, calibrated on
  the card, as ``predict --int8`` runs it), which leaves the pooling and
  the heads in bf16;
* ``answer``: the class scores of every 32nd window of each forward
  reversed where the forward produces them;
* ``half_batch``: ``predict``: the second half of each batch left out of
  the reduce; ``train``: the loss (and so the gradient) taken over the
  first half of each batch;
* ``state``: ``train``: the optimizer returns its state and the
  parameters unchanged.

The benchmark's own runs never plant anything; ``benchmark/tests`` drive
the same plants at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PLANTS = ("none", "control", "int8", "answer", "half_batch", "state")
#: the ``answer`` plant reverses the class scores of every this-many-th row
ALTER_EVERY = 32


@contextlib.contextmanager
def planted(plant: str, flow: str):
    """The program with ``plant`` under it, for the length of the block."""
    from benchmark.harness.spans import patched

    if plant == "none":
        yield
        return
    if flow == "predict" and plant == "answer":
        from jaeger_tpu_torch.infer.engine import InferenceEngine

        forward = InferenceEngine._forward

        def altered(self, bases, lengths, dense=False, mask_cut=None):
            out = dict(forward(self, bases, lengths, dense, mask_cut))
            z = out["prediction"].clone()
            z[::ALTER_EVERY] = z[::ALTER_EVERY].flip(-1)
            out["prediction"] = z
            return out

        with patched([(InferenceEngine, "_forward", altered)]):
            yield
        return
    if flow == "predict" and plant == "half_batch":
        from jaeger_tpu_torch.infer import engine as eng_mod

        orig = eng_mod.contig_partials

        def half(logits, seg_ids, valid, num_segments, reliability=None):
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
            return orig(logits, seg_ids, valid, num_segments, reliability)

        with patched([(eng_mod, "contig_partials", half)]):
            yield
        return
    if flow == "predict" and plant == "int8":
        from benchmark.harness import program

        orig_build = program.build_program

        def int8_build(model_cfg, weights, precision, device):
            from jaeger_tpu_torch.models.artifacts import save_model
            from jaeger_tpu_torch.models.conversion import (load_quantized,
                                                             quantize_bundle)

            model = orig_build(model_cfg, weights, precision, device)
            with tempfile.TemporaryDirectory() as d:
                save_model(model.state_dict(), {"model": model_cfg}, Path(d) / "f")
                quantize_bundle(Path(d) / "f", Path(d) / "q", "full_int8", device)
                q, _, _ = load_quantized(Path(d) / "q",
                                         dtype=program.DTYPES[precision],
                                         device=device)
            return q

        with patched([(program, "build_program", int8_build)]):
            yield
        return
    if flow == "train" and plant == "state":
        import torch

        from jaeger_tpu_torch.train.optimizers import Optimizer

        def frozen(self, grads, state, params):
            return {k: torch.zeros_like(g) for k, g in grads.items()}, state

        with patched([(Optimizer, "update", frozen)]):
            yield
        return
    if flow == "train" and plant == "half_batch":
        from jaeger_tpu_torch.train import losses

        orig_loss = losses.LOSSES["categorical_crossentropy"]

        def half(labels, logits, **kw):
            h = labels.shape[0] // 2
            return orig_loss(labels[:h], logits[:h], **kw)

        table = dict(losses.LOSSES, categorical_crossentropy=half)
        with patched([(losses, "LOSSES", table)]):
            yield
        return
    raise ValueError(f"no plant {plant!r} for {flow}")


def control_predict(cell, seed: int, device) -> dict:
    """The reference rounded to float8 in the program's place: the windows
    of a sample of one pass's contigs (drawn as the driver draws it), judged as
    the driver judges the program's."""
    from benchmark.harness.weights import seeded_weights
    from benchmark.reference.judge import judge_predict
    from benchmark.reference.reduce import contig_reduce
    from benchmark.reference.windows import contig_windows

    import numpy as np

    drv = cell.driver()
    s = cell.settings
    fsize, stride = int(s["fsize"]), int(s["stride"])
    with tempfile.TemporaryDirectory() as d:
        seqs = cell.generator().make(cell.traffic["params"], seed, Path(d))["seqs"]
    n = len(seqs)
    sample = drv._sample(np.arange(n), seqs, n, seed, int(s.get("check_windows", 1024)),
                         fsize, stride)
    contigs = {g: contig_windows(seqs[g], fsize, stride, fsize) for g in sample}
    weights = seeded_weights(cell.config["model"], seed, device)
    ref, rounded, low = (
        drv.reference_windows(cell.config["model"], weights, contigs, device,
                              rounding=rounding)
        for rounding in ("float32", s["precision"], "float8"))
    results = {}
    for g, (z, r) in low.items():
        red = contig_reduce(z, r)
        results[g] = {"n_windows": len(z), "frag_pred": red["classes"],
                      "pred_sum": red["mean"], "reliability": red.get("reliability")}
    return judge_predict(results, {g: len(contigs[g][1]) for g in sample}, ref, low,
                         rounded)


def control_train(cell, seed: int, device) -> dict:
    """The reference rounded to float8 in the program's place: the
    checked steps of the seed's feed from the seeded weights, judged as
    the driver judges the program's."""
    from jaeger_tpu_torch.commands.train import _label_map
    from jaeger_tpu_torch.train import data as data_lib

    from benchmark.harness.weights import seeded_weights
    from benchmark.reference.judge import judge_train
    from benchmark.reference.model import crop_nt
    from benchmark.reference.train import train_steps

    drv = cell.driver()
    s = cell.settings
    model_cfg, train_cfg = cell.config["model"], cell.config["training"]
    crop, classes = crop_nt(model_cfg), int(model_cfg["classifier_out_dim"])
    with tempfile.TemporaryDirectory() as d:
        data = cell.generator().make(cell.traffic["params"], seed, Path(d), crop, classes)
        feed = data_lib.batches_from_csv(
            [data["path"]], batch_size=int(s["batch"]), crop_nt=crop,
            num_classes=classes, shuffle_buffer=int(s.get("shuffle_buffer", 1024)),
            seed=int(seed), label_map=_label_map(model_cfg.get("string_processor", {})),
            repeat=True)
        batches = [next(feed) for _ in range(int(s.get("check_steps", 3)))]
    weights = seeded_weights(model_cfg, seed, device)

    low, ref, rounded = (
        drv._reference_run(train_steps(model_cfg, train_cfg, weights, batches, device,
                                       seed, rounding=rounding))
        for rounding in ("float8", "float32", s["precision"]))
    numbers, details = judge_train(low, ref, rounded, drv._host(weights))
    return {**numbers, "details": details}


def readings(cell, plant: str, seeds, seconds: float, device) -> list[dict]:
    """The numbers of one run per seed under ``plant``."""
    from benchmark.harness.main import run_cell

    flow = cell.traffic["driver"]
    out = []
    for seed in seeds:
        if plant == "control":
            numbers = (control_train if flow == "train" else control_predict)(
                cell, seed, device)
        else:
            from jaeger_tpu_torch.ops import int8_conv

            before = int8_conv.launches
            with planted(plant, flow):
                _, _, own = run_cell(cell, seed, seconds, False, device,
                                          time.perf_counter())
            numbers = dict(own["numbers"])
            numbers["int8_launches"] = int8_conv.launches - before
            if "check_details" in own:
                numbers["details"] = own["check_details"]
        out.append({"workload": cell.name, "plant": plant, "seed": seed, **numbers})
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/controls.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--plant", choices=PLANTS, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    from benchmark.harness.cell import load_cell
    from benchmark.harness.main import set_cache_dirs

    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("controls.py reads the card: no CUDA card found", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(cell, args.plant, seeds, args.seconds,
                        torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
