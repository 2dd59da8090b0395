"""Models are found by name (benchmark/models/<model>.py), and finding them
so moved no number: the seeded weights, the reference's logits and the
FLOP counts of both configurations equal, bit for bit, what the code
before benchmark/models/ gave (the literals below were read from it, at
these sizes, on the CPU), and the kinds build the program's
hyperparameters as they did."""

import hashlib
import os
import re

import pytest
import torch

from benchmark import flops, inputs, models, weights
from benchmark.harness import load_json
from benchmark.reference import gnn, train
from benchmark.reference.precision import CONTROL_EXACT, REFERENCE
from conftest import ROOT, TRAIN_SMALL

SEED = 2**31 + 77
GAT_LEAVES = [f"l{i}.{k}" for i in range(5) for k in ("attn_l", "attn_r", "bias", "w")]
GAT_LEAVES.insert(GAT_LEAVES.index("l2.w") + 1, "l2.w_res")
GOLDEN = {
    "gspool-7x256": {
        "leaves": [f"l{i}.{k}" for i in range(7)
                   for k in ("b_pool", "bias", "w_neigh", "w_pool", "w_self")],
        "numel": 1064360,
        "sum": -25.356569657991123,
        "sha": "a3f594a988b696125050974ee0afaf4edec05d01e2faef56284a635646524027",
        "logits": {
            "reference": "e035e458dea6513c14e8897751f091688031b29153040bbe97a0f5efd88a1071",
            "control_tf32_bf16":
                "61b442b6058af8264e35c39616443369f54accbe956b37be26488998958095e8"},
        "flops": {
            (7000, 70000): ([150360000.0, 2770432000.0, 2770432000.0, 2770432000.0,
                             2770432000.0, 2770432000.0, 964096000.0],
                            44749488000.0, 14966616000.0),
            (14813, 148130): ([318183240.0, 5862629888.0, 5862629888.0, 5862629888.0,
                               5862629888.0, 5862629888.0, 2040164864.0],
                              94696309392.0, 31671497544.0)},
    },
    "gat-4x256": {
        "leaves": GAT_LEAVES,
        "numel": 3245580,
        "sum": -131.36745613952036,
        "sha": "f4d33e287c54162797cee768f933d80b50394844783663be8f9fbac8a402eaaf",
        "logits": {
            "reference": "3f7626599ff09006bbc35df60e99950f936b35a6473480ab4c6b5139588a80b2",
            "control_tf32_bf16":
                "9fdcac6aaec0f3ccb44d816b5c027cb88a5c2d7470e0add5d0419e969c281630"},
        "flops": {
            (7000, 70000): ([459872000.0, 14853216000.0, 22149960000.0, 8387400000.0,
                             43960000.0], 137223352000.0, 45894408000.0),
            (14813, 148130): ([973154848.0, 31431526944.0, 46872479640.0,
                               17748936600.0, 93025640.0], 290384216168.0,
                              97119123672.0)},
    },
}
CONFIGS = sorted(GOLDEN)


def config(name):
    return load_json(os.path.join(ROOT, "benchmark", "configs", f"{name}.json"))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drawn(cfg):
    specs = weights.model_specs(cfg)
    return specs, weights.draw(specs, inputs.seed_generator(SEED, torch.device("cpu"), 1))


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_parents(name):
    want = GOLDEN[name]
    specs, w = drawn(config(name))
    assert [s[0] for s in specs] == want["leaves"] == list(w)
    assert sum(v.numel() for v in w.values()) == want["numel"]
    assert sum(float(v.double().sum()) for v in w.values()) == want["sum"]
    h = hashlib.sha256()
    for v in w.values():
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == want["sha"]


@pytest.mark.parametrize("prec", [REFERENCE, CONTROL_EXACT], ids=lambda p: p.name)
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_are_the_parents(name, prec, one_thread):
    """The reference on a seeded union of two graphs of the tests' size."""
    cfg = config(name)
    _, w = drawn(cfg)
    gen = inputs.seed_generator(SEED, torch.device("cpu"), 2)
    graphs = [inputs.make_train_graph(gen, TRAIN_SMALL["nodes"], tuple(TRAIN_SMALL["grid"]),
                                      10, cfg["in_feats"]) for _ in range(2)]
    feats, src, dst, _, graph = train.union(graphs, "cpu")
    with torch.no_grad():
        logits = gnn.forward(cfg, w, feats, src, dst, graph, prec)
    assert logits.shape == (2 * TRAIN_SMALL["nodes"], cfg["out_classes"])
    assert logits.dtype == prec.dtype
    assert sha(logits) == GOLDEN[name]["logits"][prec.name]


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_are_the_parents(name):
    cfg = config(name)
    for (n, e), (layers, step, fwd) in GOLDEN[name]["flops"].items():
        assert flops.gnn_layers(cfg, n, e) == layers
        assert flops.gnn_train_step(cfg, n, e) == step
        assert flops.gnn_forward(cfg, n, e) == fwd


@pytest.mark.parametrize("name", CONFIGS)
def test_hyperparams_are_those_the_kinds_built(name):
    """The generic filter gives the HyperParams the kinds spelt out key by
    key before (train: the trainer's; serve: the checkpoint's)."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams

    cfg = config(name)
    t = cfg["train"]
    assert models.hyperparams(HyperParams, cfg, train=True) == HyperParams(
        in_feats=cfg["in_feats"], out_classes=cfg["out_classes"],
        layer_sizes=list(cfg["layer_sizes"]), gat_heads=cfg.get("gat_heads"),
        gat_residuals=cfg.get("gat_residuals"), lr=t["lr"], lr_decay=t["lr_decay"],
        w_decay=t["w_decay"], class_weights=list(t["class_weights"]),
        feature_dropout=t["feature_dropout"], batch_size=t["batch_size"])
    assert models.hyperparams(HyperParams, cfg) == HyperParams(
        in_feats=cfg["in_feats"], out_classes=cfg["out_classes"],
        layer_sizes=list(cfg["layer_sizes"]), gat_heads=cfg.get("gat_heads"),
        gat_residuals=cfg.get("gat_residuals"))


def test_model_files_provide_the_interface():
    for name in models.names():
        mod = models.load(name)
        assert all(callable(getattr(mod, f)) for f in ("specs", "forward", "layer_flops"))
        assert mod.KERNELS and all(isinstance(k, str) for k in mod.KERNELS)
    assert {"GSpool", "GAT"} <= set(models.names())


def test_an_unknown_model_names_its_missing_file():
    with pytest.raises(ValueError, match=r"GraphGPS\.py"):
        weights.model_specs({"model": "GraphGPS"})


def test_port_kernels_are_the_same():
    from benchmark.records import PORT_KERNELS

    assert set(PORT_KERNELS) == {
        "max_agg_kernel", "max_agg_bwd_kernel", "sum_agg_kernel", "gat_fwd_kernel",
        "gat_bwd_kernel", "gat_rev_kernel", "wsum_kernel", "pairdot_kernel",
        "slot_gather_kernel", "slot_gather_bwd_kernel"}


def test_no_model_is_named_outside_its_file():
    """Outside benchmark/models/ no code compares a configuration's model."""
    bench = os.path.join(ROOT, "benchmark")
    pattern = re.compile(r"""\[["']model["']\]\s*(==|!=|in\b)""")
    for d, _, files in os.walk(bench):
        if os.path.relpath(d, bench).split(os.sep)[0] in ("models", "tests"):
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert not pattern.search(fh.read()), os.path.join(d, f)
