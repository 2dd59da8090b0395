"""Each cell's traffic driven end to end on the CPU at a small size, with
the program's plain kernels: the rehearsal of a chip run. A sound run is
correct and reports its metrics; a traced run its per-layer metrics."""

import math

import pytest

from benchmark.harness import cell_metrics, load_benchmark, run_cell
from conftest import ROOT, small

CELLS = [w["name"] for w in load_benchmark(ROOT)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = run_cell(cell, 2**31 + 12345, 0.5, False, device="cpu",
                              overrides=small(cell, exact=True))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = load_benchmark(ROOT)
    want = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
    assert set(result["metrics"]) == want
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in result["metrics"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["serve-gspool-deviceprep", "train-gat-b6-exact"])
def test_traced_run_reads_its_layers(cell):
    result, _ = run_cell(cell, 77, 0.5, True, device="cpu",
                         overrides=small(cell, exact=True))
    assert result["correct"]
    assert "busy_s" in result["device"] and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the kernel readers find nothing and stay silent
    assert not any("roofline" in k for k in result["metrics"])
    assert "idle_share." + ("serve" if cell.startswith("serve") else "train") in result["metrics"]


def test_same_seed_same_inputs():
    import torch

    from benchmark import inputs

    a = inputs.make_brain(inputs.seed_generator(2**33 + 1, "cpu", 3), (40, 40, 30))[0]
    b = inputs.make_brain(inputs.seed_generator(2**33 + 1, "cpu", 3), (40, 40, 30))[0]
    c = inputs.make_brain(inputs.seed_generator(2**33 + 2, "cpu", 3), (40, 40, 30))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    g1 = inputs.make_train_graph(inputs.seed_generator(9, "cpu", 2), 300, (8, 8, 6))
    g2 = inputs.make_train_graph(inputs.seed_generator(9, "cpu", 2), 300, (8, 8, 6))
    assert all((x == y).all() for x, y in zip(g1, g2))


def test_train_graphs_keep_the_degree_bucket():
    """Every seed's graphs fit the 16-slot degree bucket (regular kNN)."""
    import numpy as np

    from benchmark import inputs

    for seed in range(3):
        f, s, d, y = inputs.make_train_graph(inputs.seed_generator(seed, "cpu", 2))
        deg = np.bincount(d, minlength=len(f))
        assert len(f) == 7000 and deg.min() >= 1 and deg.max() <= 16
        assert set(np.unique(y)) <= {0, 1, 2, 3}
