"""Tests of the benchmark: `python -m pytest benchmark/tests -q` from the
root of the checkout. CPU tests run the cells at small sizes with the
program's plain kernels; tests marked `card` need the GPU and skip
without one (decided in the `card` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the CNN crop's 128^3 floor costs seconds a CPU convolution on the small
# test brains: the program and the reference both read the tests' floor
os.environ.setdefault("GTS_CNN_CROP_FLOOR", "none")

# small sizes of each traffic kind for CPU runs
SERVE_SMALL = {"brain_shape": [64, 60, 48], "num_nodes": 400,
               "crop_floor": [0, 0, 0], "brains": 2, "check_requests": 1,
               "trace_requests": 1}
TRAIN_SMALL = {"epoch_graphs": 40, "graphs": 8, "nodes": 300, "grid": [8, 8, 6]}
SMALL = {"serve_closed_loop": SERVE_SMALL, "train_epochs": TRAIN_SMALL}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small(cell_name: str, exact: bool = False) -> dict:
    """Small-size overrides of a cell's traffic. `exact` trains in exact
    precision: the limits hold the cells' bf16 training at their own size
    on the card, and bf16 on the CPU at a few hundred nodes rounds
    differently; in exact precision the program meets the reference to
    about 1e-5, which any limit admits."""
    from benchmark.harness import load_benchmark, load_cell

    cell = load_cell(load_benchmark(ROOT), cell_name, ROOT)
    out = dict(SMALL[cell.traffic["kind"]])
    if exact and cell.traffic["kind"] == "train_epochs":
        out["precision"] = "exact"
    return out
