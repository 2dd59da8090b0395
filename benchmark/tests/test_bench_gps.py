"""The GraphGPS configuration (models/GPS.py, configs/gps-gatedgcn-4x96.json,
the cell train-gps-b6) and what reads it: found by name with no file of
the benchmark edited; its weights, reference logits and FLOPs pinned (the
literals were read from this code at these sizes, on the CPU); the
attention's and the slot gather's bounds on hand-counted shapes; the
metric readers on records with and without what they read; the cell run
at a small size on the CPU, correct, and not correct under each planted
fault."""

import hashlib
import os

import pytest
import torch

from benchmark import flops, inputs, weights
from benchmark.faults import planted
from benchmark.harness import cell_metrics, import_file, load_benchmark, load_cell, load_json, run_cell
from benchmark.peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S
from benchmark.reference import gnn, train
from benchmark.reference.precision import CONTROL_FAST, REFERENCE
from benchmark.roofline import gps_attn, slot_gather
from conftest import ROOT, TRAIN_SMALL, small

CELL, CONFIG = "train-gps-b6", "gps-gatedgcn-4x96"
SEED = 2**31 + 77
NEW_METRICS = ("gps_attn_roofline.train", "train.attn_pad_share",
               "slot_gather_roofline.train")
GOLDEN = {
    "leaves": 118, "numel": 510724, "sum": 30.116001911668633,
    "sha": "6e37e4e475a593197a29ee6d51922536058b210fac0d59c2d2b1d6018a68e9d7",
    "logits": {
        "reference": "a09bb913265a87e4a7cdc14a46165cd48f615d1162cd7be0cb54aebd009c1616",
        "control_fp8": "add0a4fa4f4dfd46d71fb7def371674d34c9fd452a4b2d10ab7c986691b4b2f9"},
    "flops": {
        (7000, 70000): ([295680000.0] + [21681408000.0] * 4 + [263424000.0],
                        261558528000.0, 87284736000.0),
        (14813, 148130): ([625701120.0] + [90322800768.0] * 4 + [557442816.0],
                          1086797339904.0, 362474347008.0)},
}


def config():
    return load_json(os.path.join(ROOT, "benchmark", "configs", f"{CONFIG}.json"))


def metric(name):
    return import_file(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"),
                       f"benchmark.metrics.{name.replace('.', '_')}")


def test_found_by_name():
    bench = load_benchmark(ROOT)
    cell = load_cell(bench, CELL, ROOT)
    assert cell.config["model"] == "GPS" and cell.traffic["kind"] == "train_epochs"
    assert cell.entry["chips"] == 1 and cell.entry["traffic"] == "train-brats-b6"
    assert set(cell.limits) == {"loss_err", "grad_err", "change_err", "window_loss_err",
                                "window_grad_err", "window_change_err"}
    e2e = {m["name"] for m in cell_metrics(bench, CELL, "end_to_end")}
    assert e2e == {"setup_s", "train_samples_per_s"}
    per = {m["name"] for m in cell_metrics(bench, CELL, "per_layer")}
    # not mfu.train: a traced epoch of this cell outlasts the window, so the
    # traced run has no untraced epoch and its wall would be the trace's
    assert per == {"idle_share.train", "train.torch_ops_ms",
                   "train.host_batch_ms", "train.host_replay_ms",
                   "train.graph_step_share", *NEW_METRICS}
    # the other cells report none of the new metrics
    for other in ("train-gspool-b6", "train-gat-b6-exact"):
        names = {m["name"] for m in cell_metrics(bench, other, "per_layer")}
        assert not names & set(NEW_METRICS)


def test_weights_reference_and_flops_are_pinned():
    torch.set_num_threads(1)
    cfg = config()
    specs = weights.model_specs(cfg)
    w = weights.draw(specs, inputs.seed_generator(SEED, torch.device("cpu"), 1))
    assert len(specs) == GOLDEN["leaves"]
    assert sum(v.numel() for v in w.values()) == GOLDEN["numel"]
    assert sum(float(v.double().sum()) for v in w.values()) == GOLDEN["sum"]
    h = hashlib.sha256()
    for v in w.values():
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == GOLDEN["sha"]
    gen = inputs.seed_generator(SEED, torch.device("cpu"), 2)
    graphs = [inputs.make_train_graph(gen, TRAIN_SMALL["nodes"], tuple(TRAIN_SMALL["grid"]),
                                      10, cfg["in_feats"]) for _ in range(2)]
    feats, src, dst, _, graph = train.union(graphs, "cpu")
    for prec in (REFERENCE, CONTROL_FAST):
        with torch.no_grad():
            logits = gnn.forward(cfg, w, feats, src, dst, graph, prec)
        assert logits.shape == (2 * TRAIN_SMALL["nodes"], cfg["out_classes"])
        digest = hashlib.sha256(logits.contiguous().numpy().tobytes()).hexdigest()
        assert digest == GOLDEN["logits"][prec.name]
    for (n, e), (layers, step, fwd) in GOLDEN["flops"].items():
        assert flops.gnn_layers(cfg, n, e) == layers
        assert flops.gnn_train_step(cfg, n, e) == step
        assert flops.gnn_forward(cfg, n, e) == fwd


def test_attention_flops_are_the_real_pairs():
    """One 96-wide layer over a graph of n nodes: the attention's 4 n^2 W
    beside the n-linear products; twice n, four times the pair term."""
    ref = __import__("benchmark.models", fromlist=["load"]).load("GPS")
    a, b = ref.gps_layer(1000, 0, 96), ref.gps_layer(2000, 0, 96)
    assert b - 2 * a == pytest.approx(4.0 * 96 * (2000 ** 2 - 2 * 1000 ** 2))


SHAPES = {"B": 6, "N": 8192, "D": 24, "es": 2, "referenced": 42000.0, "live": 42000.0}


@pytest.mark.parametrize("precision,peak", [("fast", BF16_FLOPS), ("exact", FP32_FLOPS)])
def test_attention_bound_by_hand(precision, peak):
    """6 graphs of 7 000 real nodes, 8 heads of 12: 6 x 7000^2 x 8 =
    2.352e9 real pairs a layer; 4 x 12 flops a pair forward, 10 x 12
    backward; the FLOP floor exceeds the bytes' at both peaks."""
    pairs = 6 * 7000 ** 2 * 8
    assert gps_attn.real_pairs(SHAPES) * 8 == pytest.approx(pairs)
    want = 4 * (4 * 12 + 10 * 12) * pairs / peak
    shapes = dict(SHAPES, es=2 if precision == "fast" else 4)
    assert gps_attn.step_bound_s(shapes, 4, 96, 8, precision) == pytest.approx(want, rel=1e-12)
    # the bytes at head width 16: q, k, v, o and the log-sum-exp forward
    fwd = 4 * 6 * 8192 * 8 * 16 * 2 + 6 * 8 * 8192 * 4
    assert gps_attn.forward_bytes(6, 8192, 8, 16, 2) == fwd
    assert fwd / HBM_BYTES_PER_S < 4 * 12 * pairs / BF16_FLOPS


def test_slot_gather_bytes_by_hand():
    table = 6 * 8192 * 24 * 4
    fwd = 42000 * 192 * 2 + 2 * table + 6 * 8192 * 24 * 192 * 2
    assert slot_gather.forward_bytes(6, 8192, 24, 192, 2, 42000) == fwd == 478550016
    bwd = 70000 * 6 * 192 * 2 + 3 * table + 6 * 8192 * 192 * 2
    assert slot_gather.backward_bytes(6, 8192, 24, 192, 2, 420000) == bwd
    launches = [(20, 4, False), (192, 2, True)]
    want = (slot_gather.forward_bytes(6, 8192, 24, 20, 4, 42000) + fwd + bwd) / HBM_BYTES_PER_S
    assert slot_gather.step_bound_s(SHAPES, launches, 420000) == pytest.approx(want)


def _record(kernels, epochs=None):
    return {"kind": "train", "config": config(), "precision": "fast", "shapes": SHAPES,
            "epochs": epochs or [{"wall": 1.0, "steps": 10, "traced": True}],
            "trace": {"kernel_s": {k: s for k, (s, _) in kernels.items()},
                      "kernel_n": {k: n for k, (_, n) in kernels.items()}}}


def test_attention_roofline_reads_its_kernels():
    kernels = {"void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32>>": (0.02, 40),
               "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<x>": (0.05, 40),
               "void pytorch_flash::flash_bwd_dot_do_o_kernel<x>": (0.001, 40),
               "ampere_bf16_s16816gemm_bf16": (0.5, 400)}
    got = metric("gps_attn_roofline.train").read(_record(kernels), None)
    want = 100.0 * 10 * gps_attn.step_bound_s(SHAPES, 4, 96, 8, "fast") / 0.071
    assert got == pytest.approx(want)
    assert metric("gps_attn_roofline.train").read(_record({"gemm": (1.0, 1)}), None) is None


def test_readers_find_nothing_where_the_program_keeps_nothing():
    """The parent's program has no GPS: no attention kernels, no counters."""
    record = _record({"max_agg_kernel": (0.1, 70)})
    for name in NEW_METRICS:
        assert metric(name).read(record, None) is None, name
    assert metric("train.attn_pad_share").read({"kind": "serve"}, None) is None


def test_cell_runs_correct_on_the_cpu():
    """The cell at the tests' small size in exact precision (bf16 rounds
    differently at a few hundred nodes): correct, its counters read, and
    the pairs it pads are the bucket's."""
    res, checks = run_cell(CELL, SEED, 0.5, False, device="cpu",
                           overrides=small(CELL, exact=True))
    assert res["correct"], checks
    res, _ = run_cell(CELL, SEED, 0.5, True, device="cpu",
                      overrides=small(CELL, exact=True))
    share = res["metrics"]["train.attn_pad_share"]["value"]
    n, n_pad = TRAIN_SMALL["nodes"], 512
    assert share == pytest.approx(100.0 * (1 - n * n / n_pad ** 2), rel=0.05)


@pytest.mark.parametrize("fault,numbers", [
    ("unchanged", {"grad_err", "change_err", "window_change_err"}),
    ("half", {"loss_err", "window_loss_err"}),
    ("altered", {"grad_err"}),
    # sound while epoch 0 fills the cache: only the window's steps show it
    ("cache_stale", {"window_loss_err"}),
])
def test_planted_fault_is_not_correct(fault, numbers):
    """Each fault a train cell can have (faults.py), planted under the
    cell at the small size in exact precision: not correct, and the
    numbers that the fault moves are among those that fail."""
    with planted(fault):
        res, checks = run_cell(CELL, SEED, 0.5, False, device="cpu",
                               overrides=small(CELL, exact=True))
    failing = {k for k, c in checks.items() if not c["value"] <= c["limit"]}
    assert not res["correct"]
    assert numbers <= failing, checks
    if fault == "cache_stale":
        assert not {"loss_err", "grad_err", "change_err"} & failing, checks
