"""Distribution: the port's parallel/ package against the JAX package's on
the same inputs, at P = 2 and 4 ranks.

The port's ranks are spawned processes over one gloo group on the CPU
(tests/torch_port_dist_workers.py, which imports no JAX); the JAX side runs
on the virtual CPU devices of tests/conftest.py (`make_mesh(P, 1)`), as
tests/test_parallel.py does. Each world runs once per module (a fixture)
and every case reads its results. Parameters are the JAX models' own,
passed as flatten-order leaves. Tolerances:
  * partitions, exchange accounting, process shards: equal;
  * halo own-row logits, global loss and every parameter gradient against
    the JAX halo models in "exact": rtol/atol 1e-5;
  * p2p gradients against all_gather gradients: rtol/atol 1e-5;
  * one DP epoch at P = 2 against the port's single-device trainer: loss
    within 1e-5, parameters within atol 2e-5 (JAX
    test_parallel_matches_single_device's bar).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.models.gat import GAT as JaxGAT
from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxSage
from gnn_tumor_seg_tpu.parallel import halo as jhalo
from gnn_tumor_seg_tpu.parallel import multihost as jmultihost
from gnn_tumor_seg_tpu.parallel.mesh import make_mesh
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.parallel import halo, multihost
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer

import torch_port_dist_workers as workers

N_NODES, F_IN = 128, 12
CW = np.asarray(workers.CLASS_WEIGHTS, np.float32)
CASES = [
    {"name": "pool", "model_type": "GSpool", "agg": "pool", "layers": [16, 16]},
    {"name": "mean", "model_type": "GSmean", "agg": "mean", "layers": [16, 16]},
    {"name": "gcn", "model_type": "GSgcn", "agg": "gcn", "layers": [16, 16]},
    {"name": "gat", "model_type": "GAT", "layers": [8, 8], "heads": [2, 2],
     "residuals": [False, True]},
]
TRAIN_CASES = [{"model_type": m, "variant": v, "layers": [16, 16],
                **({"heads": [2, 2], "residuals": [False, True]}
                   if m == "GAT" else {})}
               for m in ("GSpool", "GAT") for v in ("p2p", "all_gather")]
DP_SPEC = {"model_type": "GSmean",
           "data": {"n_samples": 6, "grid": 4, "seed": 9},
           "hp": {"n_epochs": 1, "layer_sizes": [16], "lr": 1e-3,
                  "batch_size": 4}}


def _local_graph(seed=12, n=N_NODES, f_dim=F_IN):
    """Edges i <-> i+1..3 (1-shard locality at P <= 4), random features."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    for off in (1, 2, 3):
        a = np.arange(0, n - off)
        src_l += [a, a + off]
        dst_l += [a + off, a]
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    feats = rng.normal(size=(n, f_dim)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    return feats, src, dst, labels


def _jax_base(case):
    if case["model_type"] == "GAT":
        return JaxGAT(F_IN, case["layers"], 4, case["heads"], case["residuals"])
    return JaxSage(F_IN, case["layers"], 4, case["agg"])


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The inputs every world reads: the graph, each case's JAX params."""
    d = tmp_path_factory.mktemp("dist")
    feats, src, dst, labels = _local_graph()
    arrays = {"feats": feats, "src": src, "dst": dst, "labels": labels,
              "tlabels": (np.arange(N_NODES) * 4 // N_NODES).astype(np.int32)}
    params = {}
    cases = []
    for i, case in enumerate(CASES):
        p = _jax_base(case).init(jax.random.PRNGKey(3 + i))
        params[case["name"]] = p
        leaves = jax.tree_util.tree_leaves(p)
        for j, leaf in enumerate(leaves):
            arrays[f"{case['name']}/{j}"] = np.asarray(leaf)
        cases.append({**case, "n_leaves": len(leaves)})
    arrays["cases"] = np.asarray(json.dumps(cases))
    arrays["training"] = np.asarray(json.dumps(
        {"cases": TRAIN_CASES, "lr": 5e-3, "epochs": 6, "precision": "exact"}))
    path = str(d / "spec.npz")
    np.savez(path, **arrays)
    return {"dir": d, "path": path, "params": params,
            "graph": (feats, src, dst, labels)}


def _rank_files(d, name, world):
    return [dict(np.load(os.path.join(d, f"{name}_r{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(spec):
    """get(P) -> the results of one world of P ranks, run once per module:
    the halo cases and the collectives, and at P=2 also the DP epoch and
    the halo trainer."""
    done = {}

    def get(P):
        if P in done:
            return done[P]
        out = str(spec["dir"] / f"w{P}")
        os.makedirs(out)
        workers.run_world(workers.halo_cases, P, (out, spec["path"]),
                          deadline_s=150)
        workers.run_world(workers.collectives, P, (out,), deadline_s=60)
        res = {"P": P, "dir": out,
               "halo": _rank_files(out, "halo", P),
               "coll": _rank_files(out, "coll", P)}
        if P == 2:
            workers.run_world(workers.dp_epoch, P, (out, json.dumps(DP_SPEC)),
                              deadline_s=120)
            workers.run_world(workers.halo_training, P, (out, spec["path"]),
                              deadline_s=150)
            res["dp"] = _rank_files(out, "dp", P)
            res["train"] = _rank_files(out, "train", P)
        done[P] = res
        return res

    return get


# ------------------------------------------------------------ host numpy


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["all_gather", "p2p"])
def test_partitions_match_jax_bitwise(kind, P):
    feats, src, dst, labels = _local_graph()
    w = np.random.default_rng(1).random(len(src)).astype(np.float32)
    if kind == "p2p":
        (pg, W), (jpg, jW) = (
            halo.partition_graph_p2p(feats, src, dst, labels, P, edge_weights=w),
            jhalo.partition_graph_p2p(feats, src, dst, labels, P, edge_weights=w))
        assert W == jW
    else:
        pg = halo.partition_graph(feats, src, dst, labels, P, edge_weights=w)
        jpg = jhalo.partition_graph(feats, src, dst, labels, P, edge_weights=w)
    for name in ("nbr", "nbr_mask", "node_mask", "feats", "labels",
                 "edge_weight"):
        a, b = getattr(pg, name), np.asarray(getattr(jpg, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_p2p_refuses_nonlocal_edges():
    feats = np.zeros((64, 4), np.float32)
    src, dst = np.array([0, 63], np.int32), np.array([63, 0], np.int32)
    with pytest.raises(ValueError, match="non-adjacent"):
        halo.partition_graph_p2p(feats, src, dst, None, n_parts=4)
    with pytest.raises(ValueError):
        jhalo.partition_graph_p2p(feats, src, dst, None, n_parts=4)


@pytest.mark.parametrize("variant", ["all_gather", "p2p"])
@pytest.mark.parametrize("name", ["pool", "gat"])
def test_exchange_bytes_match_jax(name, variant):
    case = next(c for c in CASES if c["name"] == name)
    feats, src, dst, labels = _local_graph()
    hp = HyperParams(in_feats=F_IN, layer_sizes=case["layers"],
                     gat_heads=case.get("heads"),
                     gat_residuals=case.get("residuals"))
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net

    base, jbase = init_graph_net(case["model_type"], hp), _jax_base(case)
    if variant == "p2p":
        pg, W = halo.partition_graph_p2p(feats, src, dst, labels, 4)
        jpg, _ = jhalo.partition_graph_p2p(feats, src, dst, labels, 4)
    else:
        pg, W = halo.partition_graph(feats, src, dst, labels, 4), None
        jpg = jhalo.partition_graph(feats, src, dst, labels, 4)
    for nbytes in (4, 2):
        assert (halo.exchange_bytes_per_step(base, pg, variant, W, nbytes)
                == jhalo.exchange_bytes_per_step(jbase, jpg, variant, W, nbytes))


def test_process_shard_matches_jax():
    items = list(range(11))
    for n in (1, 2, 3, 4):
        for p in range(n):
            assert (multihost.process_shard(items, p, n)
                    == jmultihost.process_shard(items, p, n))
    m, c, k = multihost.combine_eval_results(np.ones(10), np.ones(8), 3)
    assert k == 3 and np.array_equal(m, np.ones(10))


# ------------------------------------------------------------ collectives


@pytest.mark.parametrize("P", [2, 4])
def test_collectives_and_combined_metrics(worlds, P):
    res = worlds(P)["coll"]
    h = [np.arange(12.0).reshape(6, 2) + 100 * r for r in range(P)]
    g = [np.arange(8.0).reshape(4, 2) + 10 * r for r in range(P)]
    full = np.concatenate(g)
    weights = np.arange(full.size, dtype=np.float64).reshape(full.shape)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["left"], h[(r - 1) % P][-2:])
        np.testing.assert_array_equal(out["right"], h[(r + 1) % P][:2])
        want = np.zeros((6, 2))
        want[-2:] += 3.0        # my last rows went right, as its left
        want[:2] += 5.0         # my first rows went left, as its right
        np.testing.assert_array_equal(out["h_grad"], want)
        np.testing.assert_array_equal(out["full"], full)
        np.testing.assert_array_equal(out["g_grad"],
                                      P * weights[r * 4:(r + 1) * 4])
        assert out["sum"][0] == P * (P + 1) / 2
        n = np.arange(1, P + 1, dtype=np.float64)
        np.testing.assert_allclose(
            out["metrics"], (np.arange(10.0)[None] + np.arange(P)[:, None]
                             ).T @ n / n.sum())
        np.testing.assert_array_equal(out["counts"], np.full(8, n.sum()))
        assert int(out["n"]) == n.sum()


# ------------------------------------------------------------ halo models


def _jax_halo(case, variant, P, W):
    mesh = make_mesh(P, 1)
    if case["model_type"] == "GAT":
        args = (F_IN, case["layers"], 4, case["heads"], case["residuals"], mesh)
        return (jhalo.HaloGATP2P(*args, halo_width=W) if variant == "p2p"
                else jhalo.HaloGAT(*args))
    args = (F_IN, case["layers"], 4, case["agg"], mesh)
    return (jhalo.HaloGraphSageP2P(*args, halo_width=W) if variant == "p2p"
            else jhalo.HaloGraphSage(*args))


def _jax_partition(spec, variant, P):
    feats, src, dst, labels = spec["graph"]
    if variant == "p2p":
        return jhalo.partition_graph_p2p(feats, src, dst, labels, P)
    return jhalo.partition_graph(feats, src, dst, labels, P), None


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("variant", ["all_gather", "p2p"])
@pytest.mark.parametrize("name", ["pool", "mean", "gcn", "gat"])
def test_halo_forward_matches_jax(worlds, spec, name, variant, P):
    case = next(c for c in CASES if c["name"] == name)
    world = worlds(P)
    jpg, W = _jax_partition(spec, variant, P)
    model = _jax_halo(case, variant, P, W)
    want = np.asarray(jax.jit(model.apply)(spec["params"][name], jpg))
    got = np.stack([r[f"{name}/{variant}/logits"] for r in world["halo"]])
    real = np.asarray(jpg.node_mask) > 0
    assert got.shape == want.shape
    np.testing.assert_allclose(got[real], want[real], rtol=1e-5, atol=1e-5)
    if variant == "p2p":
        assert int(world["halo"][0][f"{name}/p2p/W"]) == W


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("variant", ["all_gather", "p2p"])
@pytest.mark.parametrize("name", ["pool", "gat"])
def test_halo_loss_and_grads_match_jax(worlds, spec, name, variant, P):
    case = next(c for c in CASES if c["name"] == name)
    world = worlds(P)
    jpg, W = _jax_partition(spec, variant, P)
    model = _jax_halo(case, variant, P, W)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, jpg, jnp.asarray(CW))))(spec["params"][name])
    leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    for r in world["halo"]:        # every rank holds the same loss and sums
        assert abs(float(r[f"{name}/{variant}/loss"]) - float(loss)) < 1e-5
        for i, g in enumerate(leaves):
            np.testing.assert_allclose(r[f"{name}/{variant}/grad/{i}"], g,
                                       rtol=1e-5, atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", ["pool", "mean", "gcn", "gat"])
def test_p2p_grads_match_all_gather(worlds, name, P):
    r0 = worlds(P)["halo"][0]
    n = next(c for c in CASES if c["name"] == name)
    i = 0
    while f"{name}/p2p/grad/{i}" in r0:
        np.testing.assert_allclose(r0[f"{name}/p2p/grad/{i}"],
                                   r0[f"{name}/all_gather/grad/{i}"],
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))
        i += 1
    assert i > 0, n
    assert abs(float(r0[f"{name}/p2p/loss"])
               - float(r0[f"{name}/all_gather/loss"])) < 1e-5


# ------------------------------------------------------------ DP


def test_dp_epoch_matches_single_device(worlds):
    """One exact DP epoch at P=2 equals the port's single-device trainer;
    the DP loss is the global weighted mean (the test's data give the two
    ranks different weight sums, so the mean of per-rank means differs)."""
    world = worlds(2)
    data = SyntheticGraphDataset(**DP_SPEC["data"])
    single = GNNTrainer(DP_SPEC["model_type"], HyperParams(**DP_SPEC["hp"]),
                        data, seed=0, precision="exact", device="cpu")
    want = single.run_epoch()
    r0, r1 = world["dp"]
    assert abs(float(r0["loss"]) - want) < 1e-5
    assert float(r0["loss"]) == float(r1["loss"])
    for i, p in enumerate(single.model.jax_parameters()):
        np.testing.assert_allclose(r0[f"p/{i}"], p.detach().numpy(), atol=2e-5)
        np.testing.assert_array_equal(r0[f"p/{i}"], r1[f"p/{i}"])
    # the first step's global loss against a mean of per-rank means
    (n0, d0), (n1, d1) = r0["local"][0], r1["local"][0]
    global_loss = (n0 + n1) / (d0 + d1)
    naive = 0.5 * (n0 / d0 + n1 / d1)
    assert abs(d0 - d1) > 1e-3 and abs(naive - global_loss) > 1e-4


# ------------------------------------------------------------ halo trainer


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=[f"{c['model_type']}-{c['variant']}"
                              for c in TRAIN_CASES])
def test_halo_trainer_learns_and_checkpoint_serves(worlds, spec, case):
    """Six exact epochs at P=2: the loss falls on every rank alike; rank 0's
    checkpoint resumes the trainer exactly and serves through
    load_gnn_from_checkpoint with the halo model's own-row logits."""
    world = worlds(2)
    from gnn_tumor_seg_tpu_torch.cli.common import load_gnn_from_checkpoint
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

    name = f"{case['model_type']}_{case['variant']}"
    r0, r1 = world["train"]
    losses = r0[name + "/losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_array_equal(losses, r1[name + "/losses"])
    assert bool(r0[name + "/resumed_equal"]) and bool(r1[name + "/resumed_equal"])
    feats, src, dst, _ = spec["graph"]
    _, _, fwd = load_gnn_from_checkpoint(
        os.path.join(world["dir"], name + ".ckpt"), device="cpu")
    with precision_scope("exact"):
        want = fwd(graph_from_arrays(feats, src, dst))[0].numpy()[:N_NODES]
    per = N_NODES // 2
    got = np.concatenate([r0[name + "/logits"][:per], r1[name + "/logits"][:per]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert sorted(f for f in os.listdir(world["dir"]) if f.endswith(".ckpt")
                  ) == sorted(f"{c['model_type']}_{c['variant']}.ckpt"
                              for c in TRAIN_CASES)
