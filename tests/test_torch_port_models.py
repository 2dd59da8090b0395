"""GSpool, GSmean and GSgcn: logits and training gradients of the port
against the JAX GraphSage on shared parameters.

3-layer models of width 32 on a ~300-node random graph (symmetric,
deduplicated, with the reciprocal slots training needs); the parameters
are the JAX model's, carried across by convert.gnn_params_from_jax. Both
sides run in "exact" mode, the JAX side with impl="dense". Tolerances:
logits within rtol/atol 1e-5 (float32 products summed in another order);
the parameter gradients of the weighted cross-entropy within 1e-5 of each
tensor's largest entry (relative), through the port's autograd Functions
(max: first-winner routing through rslot) against jax.grad through the JAX
package's custom VJPs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxGraphSage
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu.train.losses import weighted_cross_entropy as jax_wce
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import gnn_params_from_jax, gnn_params_to_jax
from gnn_tumor_seg_tpu_torch.models.factory import GRAPH_MODEL_TYPES, init_graph_net
from gnn_tumor_seg_tpu_torch.models.sage import LAYER_KEYS
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy

N_NODES = 300
CLASS_WEIGHTS = np.asarray([0.1, 1, 2, 2], np.float32)
AGG = {"GSpool": "pool", "GSmean": "mean", "GSgcn": "gcn"}


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    feats, src, dst, labels = random_graph(rng, N_NODES, avg_deg=5, f_dim=20)
    return (jax_graph_from_arrays(feats, src, dst, labels),
            graph_from_arrays(feats, src, dst, labels, rslot=True))


@pytest.mark.parametrize("model_type", ["GSpool", "GSmean", "GSgcn"])
def test_logits_and_gradients_match_jax(graphs, model_type):
    jg, tg = graphs
    jmodel = JaxGraphSage(20, [32, 32], 4, AGG[model_type])
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = gnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert model.aggregator == AGG[model_type]

    def jax_loss(p):
        logits = jmodel.apply(p, jg, impl="dense")
        return jax_wce(logits, jg.labels, jnp.asarray(CLASS_WEIGHTS),
                       jg.node_mask), logits

    with jax_precision("exact"):
        (_, want_logits), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
            jparams)
    with precision_scope("exact"):
        logits = model(tg, train=True)
        loss = weighted_cross_entropy(logits, tg.labels,
                                      torch.from_numpy(CLASS_WEIGHTS), tg.node_mask)
        grads = torch.autograd.grad(loss, model.jax_parameters())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(want) == len(grads) == 3 * len(LAYER_KEYS[AGG[model_type]])
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_factory_builds_every_sage_type_and_round_trips():
    hp = HyperParams(layer_sizes=[16, 16])
    assert GRAPH_MODEL_TYPES == ("GSpool", "GSmean", "GSgcn", "GAT")
    for model_type, agg in AGG.items():
        model = init_graph_net(model_type, hp, torch.Generator().manual_seed(0))
        assert model.aggregator == agg and model.num_layers == 3
        names = {n.split(".")[-1] for n, _ in model.named_parameters()}
        assert names == set(LAYER_KEYS[agg])
        back = gnn_params_from_jax(gnn_params_to_jax(model))
        for a, b in zip(model.jax_parameters(), back.jax_parameters()):
            assert torch.equal(a, b)
    # GAT builds from its heads and residuals (the identity residual here:
    # the second layer's input, 2 heads x 16, is as wide as its output)
    hp.gat_heads, hp.gat_residuals = [2, 2], [False, True]
    gat = init_graph_net("GAT", hp, torch.Generator().manual_seed(0))
    assert gat.num_layers == 3 and gat.layers[1].w_res is None
    assert [n for n, _ in gat.named_parameters()][:4] == [
        "layers.0.w", "layers.0.attn_l", "layers.0.attn_r", "layers.0.bias"]
    assert [list(layer.keys) for layer in gat.layers] == [
        ["attn_l", "attn_r", "bias", "w"]] * 3
    for layer in gat.layers:
        for name in ("w", "attn_l", "attn_r"):
            w = getattr(layer, name).detach()
            bound = 2 ** 0.5 * (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
            assert w.abs().max() <= bound and w.abs().max() > 0.5 * bound
