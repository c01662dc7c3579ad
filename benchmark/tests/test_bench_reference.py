"""The plain reference against ``jaeger_tpu_torch`` at a tiny size on the
CPU, in float32: the six-frame tokens exactly, the forward of the
flagship and of a cross-frame attention model, and a whole run of each cell through the harness (the
program's outputs judged against the reference's)."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness.main import run_cell
from benchmark.harness.program import build_program
from benchmark.harness.weights import seeded_weights
from benchmark.reference.model import Reference
from benchmark.reference.windows import contig_windows, six_frames


@pytest.mark.parametrize("crop", [65, 500, 1505, 64, 66])
def test_six_frames_equal_the_port(crop):
    from jaeger_tpu_torch.ops.encode import encode_frames

    rng = np.random.default_rng(crop)
    bases = rng.integers(0, 4, size=(64, crop)).astype(np.uint8)
    bases[::5, crop // 2: crop // 2 + 7] = 4
    lengths = np.full(64, crop, np.int64)
    lengths[::3] = rng.integers(1, crop, size=lengths[::3].shape)
    for i, n in enumerate(lengths):
        bases[i, n:] = 4
    b, ln = torch.from_numpy(bases), torch.from_numpy(lengths)
    want = encode_frames(b, ln, crop_size=crop)
    assert torch.equal(six_frames(b, ln, crop), want.long())


def test_contig_windows():
    seq = np.frombuffer(b"ACGTN" * 100 + b"acgt", np.uint8)
    wins, lengths = contig_windows(seq, 65, 60, 65)
    assert wins.shape == (8, 65) and (lengths == 65).all()
    assert wins[0, :5].tolist() == [0, 3, 2, 1, 4]
    short, ln = contig_windows(seq[:50], 65, 60, 40)
    assert short.shape == (1, 65) and ln.tolist() == [50] and (short[0, 50:] == 4).all()


@pytest.mark.parametrize("name", ["flagship.predict", "crossframe"])
def test_forward_equals_the_port(tiny_model, name):
    torch.set_num_threads(1)
    cfg = tiny_model(name)
    weights = seeded_weights(cfg, 5, torch.device("cpu"))
    model = build_program(cfg, weights, "float32", torch.device("cpu"))
    rng = np.random.default_rng(5)
    bases = rng.integers(0, 4, size=(48, 65)).astype(np.uint8)
    bases[::4, 20:26] = 4
    lengths = np.full(48, 65, np.int64)
    lengths[1::6] = 40
    b, ln = torch.from_numpy(bases), torch.from_numpy(lengths)
    with torch.no_grad():
        got = model(b, ln)
        want = Reference(cfg, weights).forward(six_frames(b, ln, 65))
    for key in ("prediction", "reliability"):
        scale = want[key].abs().max().item()
        assert (got[key] - want[key]).abs().max().item() <= 1e-5 * max(scale, 1.0), key


@pytest.mark.parametrize("workload", ["flagship.predict", "flagship.train"])
def test_whole_run_is_correct_in_float32(tiny_cell, workload):
    torch.set_num_threads(1)
    cell = tiny_cell(workload)
    _, _, own = run_cell(cell, 2**31 + 3, 1.0, False, torch.device("cpu"),
                         time.perf_counter())
    # in float32 the rounded reference is the reference: the ratios have
    # no yardstick, and the gaps themselves are held to round-off
    numbers = own["numbers"]
    if workload.endswith("train"):
        assert numbers["loss"] < 1e-5 and numbers["grad"] < 1e-4
        assert numbers["change"] < 1e-3
    else:
        assert numbers["windows"] == 0 and numbers["reduce"] == 0
        assert numbers["window_logit"] < 1e-4 and numbers["reliability_mean"] < 1e-4
