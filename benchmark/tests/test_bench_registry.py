"""Configurations, traffic mixes, kinds, cells and per-layer metrics are
found by name from files of their own: a later change adds files and
entries and edits none. Here a copy of the benchmark gains a configuration,
a mix, a kind, two cells and a metric, and runs them."""

import json
import os
import shutil

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


def add_files(root):
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
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gspool-7x64", "source": "https://example.org/x",
                             "file": "benchmark/configs/gspool-7x64.json",
                             "reduced": ["layer_sizes"], "why": "a test"})
    bench["workloads"] += [
        {"name": "train-gspool64-small", "config": "gspool-7x64",
         "traffic": "train-small", "chips": 1, "why": "a test"},
        {"name": "idle-cell", "config": "gspool-7x64", "traffic": "idle",
         "chips": 1, "why": "a test"}]
    bench["end_to_end"][2]["workloads"] += ["train-gspool64-small", "idle-cell"]
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
