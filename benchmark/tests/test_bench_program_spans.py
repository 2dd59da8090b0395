"""The readers of the program's own spans (source "program_span"): a traced
CPU run of each kind reports every such metric that lists its cell, and
against a program without the spans (a parent commit) the readers find
nothing and raise nothing."""

import math
import sys

import pytest

from benchmark.harness import import_file, load_benchmark, run_cell
from conftest import ROOT, small

BENCH = load_benchmark(ROOT)
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]
# the metrics of spans inside the program, which a parent commit lacks
INNER = ["train.host_batch_ms", "train.host_forward_ms", "train.host_backward_ms",
         "train.host_optim_ms", "serve.brain_crop_s", "serve.stats_s", "serve.knn_s",
         "serve.slic_host_s"]


def _reader(name):
    return import_file(f"{ROOT}/benchmark/metrics/{name}.py",
                       f"benchmark.metrics.{name.replace('.', '_')}")


@pytest.mark.parametrize("cell", ["train-gspool-b6", "serve-gspool-hostprep"])
def test_traced_run_reads_the_program_spans(cell):
    result, _ = run_cell(cell, 2**31 + 99, 0.5, True, device="cpu",
                         overrides=small(cell, exact=True))
    assert result["correct"]
    want = {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}
    assert want <= set(result["metrics"])
    assert all(math.isfinite(result["metrics"][k]["value"])
               and result["metrics"][k]["value"] > 0 for k in want)


def test_readers_find_nothing_without_the_spans(monkeypatch):
    import gnn_tumor_seg_tpu_torch

    monkeypatch.setitem(sys.modules, "gnn_tumor_seg_tpu_torch.spans", None)
    monkeypatch.delattr(gnn_tumor_seg_tpu_torch, "spans", raising=False)
    train = {"kind": "train", "epochs": [{"wall": 1.0, "steps": 3, "traced": False}]}
    serve = {"kind": "serve", "requests": [
        {"wall": 1.0, "traced": False,
         "stages": {"nifti_read": 0.1, "normalize": 0.2, "graph_build": 0.5}}]}
    for name in INNER:
        for record in (train, serve):
            assert _reader(name).read(record, None) is None, name
