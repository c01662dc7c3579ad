"""Each fault a cell can have, planted under the program while the rest of
a run goes on (on the CPU at a tiny size, the card check skipped), turns
``correct`` false; the same run unplanted is correct. The plants are
``benchmark/controls.py``'s, which read them on the card at the cells'
own sizes."""

import time

import pytest
import torch

from benchmark.controls import planted
from benchmark.harness.main import run_cell

FAULTS = [("flagship.predict", "answer"), ("flagship.predict", "half_batch"),
          ("flagship.train", "state"), ("flagship.train", "half_batch")]


def _run(cell, plant):
    with planted(plant, cell.traffic["driver"]):
        result, rows, _ = run_cell(cell, 2**31 + 21, 1.0, False, torch.device("cpu"),
                                   time.perf_counter())
    return result, {k: v for k, v, _ in rows}


@pytest.mark.parametrize("workload,plant", FAULTS)
def test_fault_is_not_correct(tiny_cell, workload, plant):
    torch.set_num_threads(1)
    result, numbers = _run(tiny_cell(workload, "bfloat16"), plant)
    assert not result["correct"], numbers
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload", ["flagship.predict", "flagship.train"])
def test_unplanted_bf16_run_is_correct(tiny_cell, workload):
    torch.set_num_threads(1)
    result, numbers = _run(tiny_cell(workload, "bfloat16"), "none")
    assert result["correct"], numbers


def test_unknown_plant_raises():
    with pytest.raises(ValueError):
        with planted("state", "predict"):
            pass
