"""One checkpoint file loads in both packages.

A JAX `save_checkpoint` loads in the port with every tensor equal, and a
checkpoint the port writes loads with the JAX `load_checkpoint` with every
leaf equal (no tolerance: the leaves are copied, never recomputed). The
loaded GNN's CPU forward then agrees with the JAX forward within the
"exact"-mode tolerance of test_torch_port_sage.py (rtol/atol 1e-5).
"""

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
from gnn_tumor_seg_tpu_torch.convert import cnn_params_to_jax, gnn_params_to_jax
from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
from gnn_tumor_seg_tpu_torch.models.refine_cnn import CnnRefinementNet
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint


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
