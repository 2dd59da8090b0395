"""Tensor parallelism: the port's `--mesh D,M` training (parallel/dp.py with
n_model > 1) against the JAX package's ParallelGNNTrainer on the same mesh,
and against the port's one-device trainer.

The port's ranks are spawned processes over one gloo group on the CPU
(tests/torch_port_dist_workers.py `tp_world`, which imports no JAX); the
JAX side runs on the virtual CPU devices of tests/conftest.py
(`make_mesh(n_data, n_model)`), as tests/test_parallel.py does. Each mesh,
(1, 2) and (2, 2), runs once per module (a fixture) and every case reads
its results. Both packages start from the JAX trainer's own parameters, in
"exact", on the same SyntheticGraphDataset, global batch 4 (the last batch
padded with masked copies). Tolerances:
  * `tp_leaf_spec`: JAX's rule, equal on every leaf; the GAT head rule is
    the stated exception (models/gat.py, parallel/dp.py);
  * one epoch against JAX's ParallelGNNTrainer: loss within 1e-4,
    parameters within atol 2e-5 (JAX test_parallel_matches_single_device's
    bounds);
  * the first global batch against the port's one-device trainer: loss
    within 1e-5 relative, each gradient within 1e-4 of its largest entry;
  * with feature dropout (and attention dropout on the GAT), mesh (1, 2)
    against ParallelGNNTrainer on (1, 1), both keyed on data index 0: the
    first batch's loss within 1e-5 relative and gradients within 1e-4 of
    their largest, parameters within atol 2e-5 after one epoch;
  * a "fast" run's loss falls; a checkpoint written under TP loads on one
    device and in JAX's GNNTrainer.from_checkpoint with equal leaves, and
    resumes on the mesh bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.data.synthetic import SyntheticGraphDataset as JaxSynthetic
from gnn_tumor_seg_tpu.models.factory import init_graph_net as jax_init_graph_net
from gnn_tumor_seg_tpu.parallel import dp as jdp
from gnn_tumor_seg_tpu.parallel.mesh import make_mesh
from gnn_tumor_seg_tpu.train.gnn_trainer import GNNTrainer as JaxTrainer
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.parallel import dp
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy

import torch_port_dist_workers as workers

MESHES = [(1, 2), (2, 2)]
DATA = {"n_samples": 6, "grid": 4, "seed": 9}
HP = {"n_epochs": 1, "lr": 1e-3, "batch_size": 4}
CASES = [
    {"model_type": "GSmean", "hp": {"layer_sizes": [16, 16]}},
    {"model_type": "GSpool", "hp": {"layer_sizes": [16, 16]}},
    {"model_type": "GSgcn", "hp": {"layer_sizes": [16, 16]}},
    # heads 2, 2, 2 split over M = 2 (an identity and a projected residual
    # among them), the 3-head and the output layer replicated
    {"model_type": "GAT", "hp": {"layer_sizes": [8, 8, 4, 8],
                                 "gat_heads": [2, 2, 2, 3],
                                 "gat_residuals": [False, True, True, True]}},
]
NAMES = [c["model_type"] for c in CASES]
DROP = 0.3          # feature dropout, and attention dropout on the GAT


def _jax_axis(shape, n_model):
    """JAX tp_leaf_spec as an axis: P(None, 'model') -> 1, P('model') -> 0."""
    spec = tuple(jdp.tp_leaf_spec(np.zeros(shape), n_model))
    return spec.index("model") if "model" in spec else None


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The JAX trainers' initial parameters, written for the ranks."""
    d = tmp_path_factory.mktemp("tp")
    jdata = JaxSynthetic(**DATA)
    arrays, cases, params = {}, [], {}
    for c in CASES:
        jt = JaxTrainer(c["model_type"], JaxHyperParams(**HP, **c["hp"]), jdata,
                        seed=0, impl="dense", precision="exact")
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.state.params)]
        params[c["model_type"]] = leaves
        for i, leaf in enumerate(leaves):
            arrays[f"{c['model_type']}/{i}"] = leaf
        cases.append({**c, "n_leaves": len(leaves)})
    arrays["config"] = np.asarray(json.dumps({"data": DATA, "hp": HP,
                                              "cases": cases}))
    path = str(d / "spec.npz")
    np.savez(path, **arrays)
    return {"dir": d, "path": path, "params": params}


@pytest.fixture(scope="module")
def worlds(spec):
    """get((D, M)) -> every rank's results of one (D, M) world."""
    done = {}

    def get(mesh):
        if mesh not in done:
            D, M = mesh
            out = str(spec["dir"] / f"w{D}x{M}")
            os.makedirs(out)
            workers.run_world(workers.tp_world, D * M, (M, out, spec["path"]),
                              deadline_s=150)
            done[mesh] = {"dir": out, "ranks": [
                dict(np.load(os.path.join(out, f"tp_r{r}.npz"), allow_pickle=False))
                for r in range(D * M)]}
        return done[mesh]

    return get


@pytest.fixture(scope="module")
def dropout_worlds(spec):
    """mesh -> every rank's results of tests/torch_port_dist_workers.py
    `tp_dropout_world` on meshes (1, 1) and (1, 2)."""
    done = {}
    for D, M in [(1, 1), (1, 2)]:
        out = str(spec["dir"] / f"drop{D}x{M}")
        os.makedirs(out)
        workers.run_world(workers.tp_dropout_world, D * M,
                          (M, out, spec["path"], DROP), deadline_s=120)
        done[(D, M)] = [dict(np.load(os.path.join(out, f"drop_r{r}.npz")))
                        for r in range(D * M)]
    return done


def _hp(case, cls=HyperParams):
    return cls(**HP, **case["hp"])


def _mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


# ------------------------------------------------------------ the rule


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("model_type", ["GSpool", "GSmean", "GSgcn", "GAT"])
def test_tp_leaf_spec_matches_jax(model_type, n_model):
    """tp_leaf_spec is JAX's on every leaf (widths that divide by 2 and 4
    and ones that do not); leaf_axes follows it for SAGE, and for GAT shards
    exactly the layers whose heads divide, on whole heads."""
    hp = HyperParams(in_feats=20, layer_sizes=[12, 7], gat_heads=[4, 3],
                     gat_residuals=[False, True])
    model = init_graph_net(model_type, hp)
    jmodel = jax_init_graph_net(model_type, JaxHyperParams(
        in_feats=20, layer_sizes=[12, 7], gat_heads=[4, 3],
        gat_residuals=[False, True]))
    jleaves = jax.tree_util.tree_leaves(jmodel.init(jax.random.PRNGKey(0)))
    params = model.jax_parameters()
    assert [tuple(p.shape) for p in params] == [np.shape(x) for x in jleaves]
    for p, leaf in zip(params, jleaves):
        assert dp.tp_leaf_spec(p.shape, n_model) == _jax_axis(np.shape(leaf),
                                                              n_model)
    axes = dp.leaf_axes(model, n_model)
    if model_type != "GAT":
        assert axes == [dp.tp_leaf_spec(p.shape, n_model) for p in params]
        assert any(a is not None for a in axes) and None in axes
        return
    it = iter(axes)
    for layer in model.layers:
        split = layer.num_heads % n_model == 0
        for k in layer.keys:
            want = (0 if k in ("attn_l", "attn_r", "bias") else 1) if split else None
            assert next(it) == want, (layer.num_heads, k)


def test_shard_model_keeps_whole_heads():
    """At M = 2 the 4-head layer's rank block of w holds heads 2 and 3
    whole (rank 1), attn rows likewise; the 3-head layer is replicated."""
    from gnn_tumor_seg_tpu_torch.parallel.mesh import Mesh

    hp = HyperParams(in_feats=20, layer_sizes=[5, 6], gat_heads=[4, 3],
                     gat_residuals=[False, True])
    full = init_graph_net("GAT", hp, torch.Generator().manual_seed(0))
    whole = [p.detach().clone() for p in full.jax_parameters()]
    mesh = Mesh(world_size=2, rank=1, device=torch.device("cpu"),
                backend="gloo", n_data=1, n_model=2)
    axes = dp.shard_model(full, mesh)
    l0 = full.layers[0]
    assert l0.tp_heads and not full.layers[1].tp_heads
    assert torch.equal(l0.w, whole[3][:, 10:20])           # heads 2, 3 of F=5
    assert torch.equal(l0.attn_l, whole[0][2:4])
    assert torch.equal(l0.bias, whole[2][10:20])
    for p, w, ax in zip(full.jax_parameters(), whole, axes):
        assert (ax is None) == (p.shape == w.shape)


# ------------------------------------------------------------ the mesh


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_mesh_axes_groups_and_collectives(worlds, mesh):
    D, M = mesh
    ranks = worlds(mesh)["ranks"]
    w = np.arange(12.0).reshape(2, 6)
    for r, out in enumerate(ranks):
        d, m = divmod(r, M)
        assert out["axes"].tolist() == [d, m, D, M]
        assert out["data_sum"][0] == sum(dd * M + m for dd in range(D))
        assert out["model_sum"][0] == sum(d * M + mm for mm in range(M))
        blocks = [np.arange(6.0).reshape(2, 3) + 10 * (d * M + mm)
                  for mm in range(M)]
        np.testing.assert_array_equal(out["gathered"], np.concatenate(blocks, -1))
        np.testing.assert_array_equal(out["gather_grad"], w[:, m * 3:(m + 1) * 3])
        np.testing.assert_array_equal(out["copy_grad"], M * w)


# ------------------------------------------------------------ training


def _jax_epoch(case, mesh):
    jdata = JaxSynthetic(**DATA)
    jt = jdp.ParallelGNNTrainer(case["model_type"], _hp(case, JaxHyperParams),
                                jdata, seed=0, mesh=make_mesh(*mesh),
                                impl="dense", precision="exact")
    loss = jt.run_epoch()
    return loss, [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.state.params)]


def _one_device_step(case, leaves):
    """The port's one-device loss and gradients on the first global batch."""
    data = SyntheticGraphDataset(**DATA)
    tr = GNNTrainer(case["model_type"], _hp(case), data, seed=0,
                    precision="exact", device="cpu")
    with torch.no_grad():
        for p, leaf in zip(tr.model.jax_parameters(), leaves):
            p.copy_(torch.from_numpy(np.array(leaf)))
    order = np.random.default_rng((0, 0)).permutation(len(data))
    n_pad, d_pad = tr._shape_budget
    batch = batch_graphs([data.get_graph(int(i)) for i in order[:HP["batch_size"]]],
                         n_pad=n_pad, d_pad=d_pad)
    with precision_scope("exact"):
        loss = weighted_cross_entropy(tr.model(batch, train=True), batch.labels,
                                      tr.class_weights, batch.node_mask)
        grads = torch.autograd.grad(loss, tr.model.jax_parameters())
    return loss.item(), [g.numpy() for g in grads]


@pytest.mark.parametrize("model_type", NAMES)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_tp_epoch_matches_jax(worlds, spec, mesh, model_type):
    case = next(c for c in CASES if c["model_type"] == model_type)
    ranks = worlds(mesh)["ranks"]
    want_loss, want = _jax_epoch(case, mesh)
    for out in ranks:
        assert abs(float(out[model_type + "/loss"]) - want_loss) < 1e-4
        for i, w in enumerate(want):
            np.testing.assert_allclose(out[f"{model_type}/param/{i}"], w,
                                       atol=2e-5, err_msg=str(i))


@pytest.mark.parametrize("model_type", NAMES)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_tp_grads_match_one_device(worlds, spec, mesh, model_type):
    ranks = worlds(mesh)["ranks"]
    case = next(c for c in CASES if c["model_type"] == model_type)
    loss, grads = _one_device_step(case, spec["params"][model_type])
    for out in ranks:
        assert abs(float(out[model_type + "/step_loss"]) - loss) <= 1e-5 * abs(loss)
        for i, g in enumerate(grads):
            got = out[f"{model_type}/grad/{i}"]
            assert got.shape == g.shape
            assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max(), i


@pytest.mark.parametrize("model_type", ["GSpool", "GAT"])
def test_tp_dropout_matches_one_rank(worlds, dropout_worlds, model_type):
    """The model ranks of a data index draw one device's dropout masks:
    feature dropout on the replicated h, and on the GAT's head-sharded
    layers each rank's heads of the full attention mask."""
    ref = dropout_worlds[(1, 1)][0]
    loss = float(ref[model_type + "/step_loss"])
    nodrop = float(worlds((1, 2))["ranks"][0][model_type + "/step_loss"])
    assert abs(loss - nodrop) > 1e-3 * abs(nodrop)     # the masks acted
    n = sum(k.startswith(model_type + "/grad/") for k in ref)
    for out in dropout_worlds[(1, 2)]:
        assert abs(float(out[model_type + "/step_loss"]) - loss) <= 1e-5 * abs(loss)
        assert abs(float(out[model_type + "/loss"])
                   - float(ref[model_type + "/loss"])) <= 1e-5 * abs(loss)
        for i in range(n):
            g = ref[f"{model_type}/grad/{i}"]
            got = out[f"{model_type}/grad/{i}"]
            assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max(), i
            np.testing.assert_allclose(out[f"{model_type}/param/{i}"],
                                       ref[f"{model_type}/param/{i}"],
                                       atol=2e-5, err_msg=str(i))


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_tp_fast_loss_falls(worlds, mesh):
    ranks = worlds(mesh)["ranks"]
    losses = ranks[0]["fast_losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["fast_losses"], losses)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_tp_checkpoint_loads_on_one_device_and_in_jax(worlds, mesh):
    world = worlds(mesh)
    r0 = world["ranks"][0]
    for name in NAMES:
        path = os.path.join(world["dir"], name + ".ckpt")
        assert bool(r0[name + "/resumed_equal"])
        one = GNNTrainer.from_checkpoint(path, device="cpu")
        jt = JaxTrainer.from_checkpoint(path, impl="dense")
        jleaves = jax.tree_util.tree_leaves(jt.state.params)
        for i, (p, jl) in enumerate(zip(one.model.jax_parameters(), jleaves)):
            want = r0[f"{name}/param/{i}"]
            np.testing.assert_array_equal(p.detach().numpy(), want)
            np.testing.assert_array_equal(np.asarray(jl), want)
        assert one.epoch == 1 and int(jt.state.epoch) == 1
