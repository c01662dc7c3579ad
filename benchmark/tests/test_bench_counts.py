"""Operation and byte counts against hand counts for the flagship's forms
(N = 6 x rows, L = 494 positions after the k7 VALID entry conv, C = 128,
k = 5, bf16) and a cross-frame attention model."""

import json
import math

import pytest

from benchmark.harness.cell import ROOT, load_cell, load_module
from benchmark.harness.flops import forward_flops, residual_convs

FLAGSHIP = load_cell("flagship.predict").config["model"]
CROSSFRAME = json.loads((ROOT / "benchmark/tests/data/crossframe.json").read_text())["model"]
FWD = load_module(ROOT / "benchmark/metrics/conv_fwd_roofline.predict.py", "fwd")
TRAIN = load_module(ROOT / "benchmark/metrics/conv_roofline.train.py", "train")
PEAK, HBM = 989e12, 3.35e12


def test_flagship_forward_flops():
    per_position = 2 * 7 * 196 * 128 + 6 * 2 * 5 * 128 * 128
    heads = 2 * 128 * 6 + 2 * 512 * 1
    assert forward_flops(FLAGSHIP) == 6 * 494 * per_position + heads
    assert forward_flops(FLAGSHIP, heads=("prediction",)) == (
        6 * 494 * per_position + 2 * 128 * 6)


def test_flagship_residual_convs_run_after_the_valid_entry_conv():
    assert residual_convs(FLAGSHIP) == [(494, 128, 5, True, False),
                                        (494, 128, 5, True, True)] * 3


def test_crossframe_forward_flops():
    tokens = 6 * 165
    per = (2 * 7 * 64 * 64 + 2 * (3 * 64 * 64 + 64 * 64 + 2 * 64 * 128 + 12 * 64)
           + 4 * 2 * 3 * 64 * 64)
    heads = 2 * 64 * 3 + 2 * 128 * 1
    assert forward_flops(CROSSFRAME) == tokens * per + heads


@pytest.mark.parametrize("rows,masked", [(2048, False), (128, True)])
def test_flagship_conv_forward_bound(rows, masked):
    n, length, c, k = 6 * rows, 494, 128, 5
    act = n * length * c * 2
    masks = 2 * n * length if masked else 0
    ops = 2 * n * length * k * c * c / PEAK
    conv1 = max(ops, (2 * act + k * c * c * 2 + masks) / HBM)
    conv2 = max(ops, (3 * act + k * c * c * 2 + masks) / HBM)
    got = FWD.forward_bound_s(FLAGSHIP, rows, masked, "bfloat16")
    assert math.isclose(got, 3 * (conv1 + conv2), rel_tol=1e-12)
    if rows == 2048:
        # the operations bind the first conv, the bytes the second
        assert conv1 == ops and conv2 > ops


def test_crossframe_conv_forward_bound():
    n, length, c, k = 6 * 2048, 165, 64, 3
    act = n * length * c * 2
    one = max(2 * n * length * k * c * c / PEAK, (2 * act + k * c * c * 2) / HBM)
    got = FWD.forward_bound_s(CROSSFRAME, 2048, False, "bfloat16")
    assert math.isclose(got, 4 * one, rel_tol=1e-12)


def test_flagship_train_step_bound():
    n, length, c, k = 6 * 256, 494, 128, 5
    act = n * length * c * 2
    w = k * c * c * 2
    ops = 2 * n * length * k * c * c / PEAK
    conv1 = max(ops, (2 * act + w) / HBM) + 2 * max(ops, (2 * act + w) / HBM) + 3 * act / HBM
    conv2 = max(ops, (3 * act + w) / HBM) + 2 * max(ops, (2 * act + w) / HBM) + 5 * act / HBM
    got = TRAIN.step_bound_s(FLAGSHIP, 256, "bfloat16")
    assert math.isclose(got, 3 * (conv1 + conv2), rel_tol=1e-12)
