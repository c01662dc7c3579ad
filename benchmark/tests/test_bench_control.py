"""The control on the card: the reference computed in float8 in the
program's place has to come out not correct, at the cells' own sizes.
Skips without a card; on the card: ``python -m pytest benchmark/tests -m
card``."""

import pytest
import torch

from benchmark.controls import readings
from benchmark.harness.cell import load_cell
from benchmark.reference.judge import verdict


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control reads the float8 reference "
                    "at the cells' own sizes on it")
    from benchmark.harness.main import set_cache_dirs

    set_cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["flagship.predict", "flagship.train"])
def test_control_is_not_correct(card, workload):
    cell = load_cell(workload)
    (row,) = readings(cell, "control", [2**31 + 77], 3.0, card)
    numbers = {k: row[k] for k in cell.limits}
    correct, rows = verdict(numbers, cell.limits)
    assert not correct, rows
