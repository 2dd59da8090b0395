"""One checkpoint file loads in both packages.

A JAX `save_checkpoint` loads in the port with every tensor equal, and a
checkpoint the port writes loads with the JAX `load_checkpoint` with every
leaf equal (no tolerance: the leaves are copied, never recomputed). The
loaded GNN's CPU forward then agrees with the JAX forward within the
"exact"-mode tolerance of test_torch_port_sage.py (rtol/atol 1e-5).

Every graph model takes one path into and out of a checkpoint: each of
GRAPH_MODEL_TYPES, trained an epoch, comes back through gnn_from_leaves and
through GNNTrainer.from_checkpoint with its parameters, buffers (a GPS's
running statistics), optimizer state and outputs bitwise equal, and a wrong
leaf count or shape is refused with the leaf named.
"""

import re

import jax
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.models.refine_cnn import CnnRefinementNet as JaxCnn
from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxGraphSage
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.train.checkpoint import load_checkpoint as jax_load
from gnn_tumor_seg_tpu.train.checkpoint import save_checkpoint as jax_save
from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                load_gnn_from_checkpoint)
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import (cnn_params_to_jax, gnn_params_to_jax,
                                             parameter_names)
from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
from gnn_tumor_seg_tpu_torch.models.factory import GRAPH_MODEL_TYPES, init_graph_net
from gnn_tumor_seg_tpu_torch.models.refine_cnn import CnnRefinementNet
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train.checkpoint import (gnn_from_leaves, load_checkpoint,
                                                      save_checkpoint)
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
from gnn_tumor_seg_tpu_torch.train.optim import opt_state_leaves

# small widths of every graph model; GAT and GPS with their own fields
GRAPH_HP = {
    "GSpool": {}, "GSmean": {}, "GSgcn": {},
    "GAT": dict(gat_heads=[3, 2], gat_residuals=[False, True]),
    "GPS": dict(gps_heads=2, gps_post_layers=3),
}


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_jax_gnn_checkpoint_loads_in_port(tmp_path):
    hp = JaxHyperParams(layer_sizes=[16, 8])
    jmodel = JaxGraphSage(20, hp.layer_sizes, 4, "pool")
    jparams = jmodel.init(jax.random.PRNGKey(3))
    path = str(tmp_path / "gnn.ckpt")
    jax_save(path, jparams, "GSpool", hp)

    leaves, model_type, port_hp, _ = load_checkpoint(path)
    assert model_type == "GSpool" and port_hp.layer_sizes == [16, 8]
    model, _, forward = load_gnn_from_checkpoint(path, device="cpu")
    assert _leaves_equal(jparams, gnn_params_to_jax(model))

    rng = np.random.default_rng(0)
    feats, src, dst, _ = random_graph(rng, 90, avg_deg=4, f_dim=20)
    want = np.asarray(jmodel.apply(jparams, jax_graph_from_arrays(feats, src, dst)))
    got = forward(graph_from_arrays(feats, src, dst)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_gnn_checkpoint_loads_in_jax(tmp_path):
    hp = HyperParams(layer_sizes=[12, 12, 12])
    model = init_graph_net("GSpool", hp, torch.Generator().manual_seed(5))
    path = str(tmp_path / "gnn.ckpt")
    save_checkpoint(path, model, "GSpool", hp)
    template = JaxGraphSage(20, hp.layer_sizes, 4, "pool").init(jax.random.PRNGKey(0))
    jparams, model_type, jhp, _ = jax_load(path, template)
    assert model_type == "GSpool" and jhp.layer_sizes == [12, 12, 12]
    assert _leaves_equal(jparams, gnn_params_to_jax(model))


def test_cnn_checkpoint_both_ways(tmp_path):
    hp = JaxHyperParams(in_feats=8, layer_sizes=[6])
    jnet = JaxCnn(8, 4, [6])
    jparams = jnet.init(jax.random.PRNGKey(4))
    jpath = str(tmp_path / "cnn_jax.ckpt")
    jax_save(jpath, jparams, "CNN", hp)
    net, port_hp, _ = load_cnn_from_checkpoint(jpath, device="cpu")
    assert port_hp.layer_sizes == [6]
    assert _leaves_equal(jparams, cnn_params_to_jax(net))

    mine = CnnRefinementNet(8, 4, [6], generator=torch.Generator().manual_seed(2))
    ppath = str(tmp_path / "cnn_port.ckpt")
    save_checkpoint(ppath, mine, "CNN", HyperParams(in_feats=8, layer_sizes=[6]))
    back, model_type, _, _ = jax_load(ppath, jparams)
    assert model_type == "CNN"
    assert _leaves_equal(back, cnn_params_to_jax(mine))


def test_wrong_model_type_is_refused(tmp_path):
    hp = JaxHyperParams(in_feats=8, layer_sizes=[6])
    path = str(tmp_path / "cnn.ckpt")
    jax_save(path, JaxCnn(8, 4, [6]).init(jax.random.PRNGKey(0)), "CNN", hp)
    with pytest.raises(NotImplementedError):
        load_gnn_from_checkpoint(path, device="cpu")


def _graph_hp(model_type):
    return HyperParams(layer_sizes=[8, 8], batch_size=3, **GRAPH_HP[model_type])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """model type -> (trainer after one epoch, its data, its checkpoint with
    optimizer state, the same without)."""
    data = SyntheticGraphDataset(n_samples=3, grid=4, seed=5)
    out = {}
    for model_type in GRAPH_MODEL_TYPES:
        folder = f"{tmp_path_factory.mktemp(model_type)}/"
        t = GNNTrainer(model_type, _graph_hp(model_type), data, seed=0,
                       device="cpu")
        t.run_epoch()
        t.save_weights(folder, "opt")
        t.save_weights(folder, "params", include_opt_state=False)
        out[model_type] = t, data, folder + "opt.ckpt", folder + "params.ckpt"
    return out


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("with_opt", [True, False], ids=["opt", "params"])
@pytest.mark.parametrize("model_type", GRAPH_MODEL_TYPES)
def test_every_graph_model_round_trips(trained, model_type, with_opt):
    t, data, opt_path, params_path = trained[model_type]
    path = opt_path if with_opt else params_path
    model = t.model
    leaves, ckpt_type, hp, manifest = load_checkpoint(path)
    assert ckpt_type == model_type and hp == t.hp
    assert manifest["extra"]["epoch"] == t.epoch == 1
    assert manifest["n_params"] == len(model.jax_parameters())
    assert manifest.get("n_buffers", 0) == len(list(model.buffers()))
    assert ("n_opt" in manifest) == with_opt
    if model_type == "GPS":    # trained running statistics, not the initial ones
        assert not torch.equal(next(model.buffers()), torch.zeros(8))
    loaded = gnn_from_leaves(leaves, model_type, hp, buffers=manifest.get("buffers"))
    restored = GNNTrainer.from_checkpoint(path, data, seed=1, device="cpu")
    assert restored.epoch == t.epoch
    batch = batch_graphs([data.get_graph(i) for i in range(len(data))])
    with precision_scope("exact"), torch.no_grad():
        want = model(batch)
        for other in (loaded, restored.model):
            assert type(other) is type(model)
            assert _equal(other.jax_parameters(), model.jax_parameters())
            assert _equal(other.buffers(), model.buffers())
            assert torch.equal(other(batch), want)
    got = opt_state_leaves(restored.optimizer)
    if with_opt:
        assert all(np.array_equal(a, b)
                   for a, b in zip(got, opt_state_leaves(t.optimizer), strict=True))
    else:      # the optimizer of a fresh trainer: no moments yet
        fresh = GNNTrainer(model_type, hp, data, seed=1, device="cpu")
        assert all(np.array_equal(a, b)
                   for a, b in zip(got, opt_state_leaves(fresh.optimizer), strict=True))


@pytest.mark.parametrize("model_type", GRAPH_MODEL_TYPES)
def test_buffers_are_stored_in_leaf_order(model_type):
    """The checkpoint's buffer leaves are the model's buffers in torch's
    order; the modules that own them come in the order of their leaves."""
    model = init_graph_net(model_type, _graph_hp(model_type))

    def owners(names):
        return list(dict.fromkeys(n.rsplit(".", 1)[0] for n in names))

    own = owners(n for n, _ in model.named_buffers())
    assert own == [o for o in owners(parameter_names(model)) if o in own]
    assert bool(own) == (model_type == "GPS")


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "buffer_shape"])
@pytest.mark.parametrize("model_type", GRAPH_MODEL_TYPES)
def test_wrong_leaves_are_refused_by_name(model_type, fault):
    hp = _graph_hp(model_type)
    model = init_graph_net(model_type, hp)
    names = parameter_names(model)
    leaves = [p.detach().numpy() for p in model.jax_parameters()]
    buffers = [b.numpy() for b in model.buffers()] or None
    k = len(leaves) // 2
    if fault == "missing":
        leaves, want = leaves[:-1], f"p/{len(names) - 1}: the model's {names[-1]}"
    elif fault == "extra":
        leaves, want = leaves + [leaves[0]], f"p/{len(names)}: "
    elif fault == "shape":
        leaves[k] = np.zeros(leaves[k].shape + (1,), np.float32)
        want = f"p/{k} ({names[k]}): shape"
    elif buffers is None:      # a model without buffers refuses any it is given
        buffers, want = [np.zeros(3, np.float32)], "b/0: the model has nothing"
    else:
        buffers[-1] = np.zeros(1, np.float32)
        name = list(dict(model.named_buffers()))[-1]
        want = f"b/{len(buffers) - 1} ({name}): shape"
    with pytest.raises(ValueError, match=re.escape(want)):
        gnn_from_leaves(leaves, model_type, hp, buffers=buffers)
