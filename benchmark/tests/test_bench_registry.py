"""Configurations, traffic mixes, kinds, cells, models and per-layer
metrics are found by name from files of their own: a later change adds
files and entries and edits none. Here a copy of the benchmark gains a
configuration, a mix, a kind, a model (GSmean, the program's mean
aggregator), cells and a metric, and runs them."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cell_metrics, load_benchmark, load_cell, run_cell
from conftest import ROOT, TRAIN_SMALL

NEW_KIND = '''
"""A kind that serves nothing: one unit of work a window, numbers of 0."""
import time


def setup(run):
    return {"t": time.perf_counter()}


def window(state, run):
    return {"attempted": 1, "failed": 0, "e2e": {"train_samples_per_s": 1.0},
            "record": {"kind": "idle", "epochs": [{"wall": 1.0, "steps": 1}]}}


def judge(state, run):
    return {"loss_err": 0.0, "grad_err": 0.0, "change_err": 0.0}
'''

MULTI_KIND = '''
"""A kind whose ranks ran in processes of their own: it reports the peak
bytes of each device they used."""


def setup(run):
    return {}


def window(state, run):
    return {"attempted": 1, "failed": 0, "e2e": {"train_samples_per_s": 1.0},
            "record": {"kind": "idle", "epochs": [{"wall": 1.0, "steps": 1}]},
            "devices": [1000, 3000]}


def judge(state, run):
    return {"loss_err": 0.0, "grad_err": 0.0, "change_err": 0.0}
'''

# the program's mean aggregator (gnn_tumor_seg_tpu_torch/models/sage.py)
NEW_MODEL = '''
"""GraphSAGE with the mean aggregator (the port's `GSmean`):
out_v = h_v W_self + mean_{u->v} h_u W_neigh + b, ReLU on every layer but
the last; an empty neighbourhood's mean is 0."""
import torch

from ..reference.gnn import scatter_sum
from ..weights import GNN_BIAS_BOUND, xavier

KERNELS = ("sum_agg_kernel",)


def _dims(config):
    return [config["in_feats"], *config["layer_sizes"], config["out_classes"]]


def specs(config):
    d = _dims(config)
    out = []
    for i, (fi, fo) in enumerate(zip(d[:-1], d[1:])):
        out += [(f"l{i}.bias", (fo,), GNN_BIAS_BOUND),
                (f"l{i}.w_neigh", (fi, fo), xavier(fi, fo)),
                (f"l{i}.w_self", (fi, fo), xavier(fi, fo))]
    return out


def forward(config, w, feats, src, dst, graph, prec):
    n, n_layers = feats.shape[0], len(config["layer_sizes"]) + 1
    h = feats.to(prec.dtype)
    r = prec.round
    deg = scatter_sum(torch.ones(len(dst), dtype=h.dtype, device=h.device), dst, n)
    with prec.math():
        for i in range(n_layers):
            h = r(h)
            mean = r(scatter_sum(h[src], dst, n) / deg.clamp_min(1)[:, None])
            h = r(r(r(h @ r(w[f"l{i}.w_self"].to(prec.dtype)))
                    + r(mean @ r(w[f"l{i}.w_neigh"].to(prec.dtype))))
                  + r(w[f"l{i}.bias"].to(prec.dtype)))
            if i < n_layers - 1:
                h = torch.relu(h)
    return h


def layer_flops(config, n, e):
    d = _dims(config)
    return [4.0 * n * a * b + 1.0 * e * a + 1.0 * n * a for a, b in zip(d[:-1], d[1:])]
'''

NEW_METRIC = '''
"""Mean epoch wall time of the window, in seconds."""


def read(record, cell):
    epochs = record.get("epochs") or []
    return sum(e["wall"] for e in epochs) / len(epochs) if epochs else None
'''


@pytest.fixture
def copy(tmp_path):
    """A checkout holding BENCHMARK.json and the benchmark's folder."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def add_files(root, model=NEW_MODEL):
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "gspool-7x256.json").read_text())
    cfg.update(name="gspool-7x64", layer_sizes=[64] * 6)
    (b / "configs" / "gspool-7x64.json").write_text(json.dumps(cfg))
    mix = dict(json.loads((b / "traffic" / "train-brats-b6.json").read_text()),
               **TRAIN_SMALL)
    (b / "traffic" / "train-small.json").write_text(json.dumps(mix))
    (b / "traffic" / "idle.json").write_text(json.dumps({"kind": "idle_kind"}))
    (b / "kinds" / "idle_kind.py").write_text(NEW_KIND)
    limits = {"limits": {"loss_err": 0.05, "grad_err": 0.2, "change_err": 0.5}}
    for cell in ("train-gspool64-small", "idle-cell"):
        (b / "workloads" / f"{cell}.json").write_text(json.dumps(limits))
    (b / "metrics" / "train.epoch_s.py").write_text(NEW_METRIC)
    (b / "traffic" / "multi.json").write_text(json.dumps({"kind": "multi_kind"}))
    (b / "kinds" / "multi_kind.py").write_text(MULTI_KIND)
    (b / "workloads" / "multi-cell.json").write_text(json.dumps(limits))
    (b / "models" / "GSmean.py").write_text(model)
    cfg.update(name="gsmean-7x64", model="GSmean")
    (b / "configs" / "gsmean-7x64.json").write_text(json.dumps(cfg))
    (b / "traffic" / "train-small-exact.json").write_text(
        json.dumps(dict(mix, precision="exact")))
    (b / "workloads" / "train-gsmean64-small.json").write_text(json.dumps(
        {"limits": {k: 1e-3 for k in ("loss_err", "grad_err", "change_err",
                                      "window_loss_err", "window_grad_err",
                                      "window_change_err")}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gspool-7x64", "source": "https://example.org/x",
                             "file": "benchmark/configs/gspool-7x64.json",
                             "reduced": ["layer_sizes"], "why": "a test"})
    bench["configs"].append({"name": "gsmean-7x64", "source": "https://example.org/x",
                             "file": "benchmark/configs/gsmean-7x64.json",
                             "reduced": ["layer_sizes"], "why": "a test"})
    bench["workloads"] += [
        {"name": "train-gspool64-small", "config": "gspool-7x64",
         "traffic": "train-small", "chips": 1, "why": "a test"},
        {"name": "idle-cell", "config": "gspool-7x64", "traffic": "idle",
         "chips": 1, "why": "a test"},
        {"name": "multi-cell", "config": "gspool-7x64", "traffic": "multi",
         "chips": 1, "why": "a test"},
        {"name": "train-gsmean64-small", "config": "gsmean-7x64",
         "traffic": "train-small-exact", "chips": 1, "why": "a test"}]
    bench["end_to_end"][2]["workloads"] += ["train-gspool64-small", "idle-cell",
                                            "multi-cell", "train-gsmean64-small"]
    bench["per_layer"].append({"name": "train.epoch_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_added_files_are_found_without_edits(copy):
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    add_files(copy)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    bench = load_benchmark(str(copy))
    cell = load_cell(bench, "train-gspool64-small", str(copy))
    assert cell.config["layer_sizes"] == [64] * 6
    assert cell.traffic["epoch_graphs"] == TRAIN_SMALL["epoch_graphs"]
    # a metric without a cell list reaches every cell reporting what it moves
    names = {m["name"] for m in cell_metrics(bench, "train-gat-b6-exact", "per_layer")}
    assert "train.epoch_s" in names


def test_added_cell_runs_with_its_metric(copy):
    add_files(copy)
    result, _ = run_cell("train-gspool64-small", 3, 0.5, True, device="cpu",
                         root=str(copy))
    assert result["correct"]
    assert result["metrics"]["train.epoch_s"]["value"] > 0
    result, _ = run_cell("idle-cell", 3, 0.1, False, device="cpu", root=str(copy))
    assert result["correct"] and "train_samples_per_s" in result["metrics"]


def run_in_checkout(root, cell, seed):
    """run_cell in a fresh process whose `benchmark` package is the
    checkout's own (the program from this one): (correct, checks)."""
    code = (
        "import json, sys; sys.path[:0] = [%r, %r];"
        "from benchmark.harness import run_cell;"
        "res, checks = run_cell(%r, %d, 0.5, False, device='cpu', root=%r);"
        "print(json.dumps([res['correct'], checks]))" % (str(root), ROOT, cell, seed,
                                                        str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_added_model_runs_correct(copy):
    """GSmean, added as a model file, a configuration and a cell, is held
    to its own reference: its cell comes out correct."""
    add_files(copy)
    correct, checks = run_in_checkout(copy, "train-gsmean64-small", 2**31 + 5)
    assert correct, checks


def test_a_wrong_model_reference_fails(copy):
    """With the model's forward summing where it should average, the same
    cell does not come out correct: the model file is what is judged."""
    wrong = NEW_MODEL.replace(" / deg.clamp_min(1)[:, None]", "")
    assert wrong != NEW_MODEL
    add_files(copy, wrong)
    correct, checks = run_in_checkout(copy, "train-gsmean64-small", 2**31 + 5)
    assert not correct
    assert checks["loss_err"]["value"] > checks["loss_err"]["limit"], checks


def test_union_marks_each_nodes_graph():
    import numpy as np
    import torch

    from benchmark.reference.train import union

    rng = np.random.default_rng(0)
    sizes = (5, 1, 7)
    graphs = [(rng.random((n, 3)), rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n),
               rng.integers(0, 4, n)) for n in sizes]
    feats, src, dst, labels, graph = union(graphs, "cpu")
    assert graph.dtype == torch.int64
    assert graph.tolist() == [i for i, n in enumerate(sizes) for _ in range(n)]
    # every edge stays inside its graph
    assert torch.equal(graph[src], graph[dst])
    assert len(feats) == len(labels) == len(graph) == sum(sizes)


def test_device_info_of_ranks_in_other_processes(copy):
    """A kind that reports `devices` gives their number and the fullest
    one's peak; one that reports none reads as before."""
    add_files(copy)
    result, _ = run_cell("multi-cell", 3, 0.1, False, device="cpu", root=str(copy))
    assert result["device"]["count"] == 2
    assert result["device"]["memory_peak_bytes"] == 3000
    result, _ = run_cell("idle-cell", 3, 0.1, False, device="cpu", root=str(copy))
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}
