"""`correct` comes out false when the timed path is broken underneath, once
for each fault a cell can have, and when the control (the reference one
precision step down, in the program's place) stands in for the program.
Small sizes on the CPU, the harness's look for a card skipped; the same
controls at the cells' own sizes run on the card with control.py."""

import numpy as np
import pytest

from benchmark.control import control_numbers
from benchmark.faults import planted
from benchmark.harness import load_benchmark, load_cell, run_cell
from conftest import ROOT, small

SERVE = "serve-gspool-deviceprep"
TRAIN = ["train-gspool-b6", "train-gat-b6-exact"]


def run(cell, seconds=0.5, **overrides):
    result, checks = run_cell(cell, 4242, seconds, False, device="cpu",
                              overrides=dict(small(cell), **overrides))
    return result, checks


def failing(checks):
    return sorted(k for k, c in checks.items() if not c["value"] <= c["limit"])


@pytest.mark.parametrize("fault,numbers,seconds", [
    ("gnn_node", {"gnn_err"}, 0.5),
    ("gnn_half", {"gnn_err"}, 0.5),
    ("label", {"label_gap"}, 0.5),
    # a window long enough to reach the judged requests of both brains
    ("stale", {"label_gap"}, 4),
    ("connectivity", {"partition_mismatch"}, 0.5),
])
def test_serve_fault(fault, numbers, seconds):
    with planted(fault):
        result, checks = run(SERVE, seconds=seconds, check_requests=2)
    assert not result["correct"]
    assert numbers <= set(failing(checks)), checks


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault,numbers", [
    ("unchanged", {"grad_err", "change_err", "window_change_err"}),
    ("half", {"loss_err", "window_loss_err"}),
    ("altered", {"grad_err"}),
    # sound while epoch 0 fills the cache: only the window's steps show it
    ("cache_stale", {"window_loss_err"}),
])
def test_train_fault(cell, fault, numbers):
    with planted(fault):
        result, checks = run(cell)
    assert not result["correct"]
    assert numbers <= set(failing(checks)), checks
    if fault == "cache_stale":
        assert not {"loss_err", "grad_err", "change_err"} & set(failing(checks))


@pytest.mark.parametrize("seed", range(6))
def test_connectivity_reference_is_the_pass(seed):
    """The reference's connectivity pass gives the program's partition on
    volumes of fragmented cells (the program's native pass and its
    contiguous ids)."""
    import torch

    from benchmark.reference.serve import connectivity
    from gnn_tumor_seg_tpu_torch.data import native
    from gnn_tumor_seg_tpu_torch.data.slic import _relabel_contiguous

    if not native.available():
        pytest.skip("the program's native library did not build")
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in rng.integers(6, 28, 3))
    k = int(rng.integers(2, 40))
    blocks = rng.integers(0, k, size=tuple(-(-s // 4) for s in shape))
    cells = np.kron(blocks, np.ones((4, 4, 4), np.int64))[:shape[0], :shape[1], :shape[2]]
    noise = rng.random(shape) < 0.05 * (seed + 1)
    cells = np.where(noise, rng.integers(0, k, shape), cells).astype(np.int32)
    want = _relabel_contiguous(native.enforce_connectivity_native(cells))
    got = connectivity(torch.from_numpy(cells)).numpy()
    assert np.array_equal(got, want)


# -------------------------------------------------------------- controls
@pytest.mark.parametrize("cell", [w["name"] for w in load_benchmark(ROOT)["workloads"]])
def test_control_is_not_correct(cell):
    limits = load_cell(load_benchmark(ROOT), cell, ROOT).limits
    numbers = control_numbers(cell, 31, device="cpu", overrides=small(cell))
    assert any(not numbers[k] <= limits[k] for k in limits), numbers
    assert all(np.isfinite(v) for v in numbers.values())
