"""On the card, at the cells' own sizes: a short run of each cell is
correct and its control is not. Marked `card`; the `card` fixture skips
them without a CUDA device."""

import pytest

from benchmark.control import control_numbers
from benchmark.harness import load_benchmark, load_cell, run_cell
from conftest import ROOT

CELLS = [w["name"] for w in load_benchmark(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_short_run_is_correct(card, cell, monkeypatch):
    monkeypatch.delenv("GTS_CNN_CROP_FLOOR", raising=False)
    result, checks = run_cell(cell, 2**31 + 99, 3, False, device="cuda")
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_control_is_not_correct(card, cell, monkeypatch):
    monkeypatch.delenv("GTS_CNN_CROP_FLOOR", raising=False)
    limits = load_cell(load_benchmark(ROOT), cell, ROOT).limits
    numbers = control_numbers(cell, 2**31 + 98, device="cuda")
    assert any(not numbers[k] <= limits[k] for k in limits), numbers
