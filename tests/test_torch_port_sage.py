"""GSpool forward: the port against the JAX GraphSage on shared parameters.

A 3-layer GSpool of width 32 on a ~300-node random graph; the parameters are
the JAX model's, carried across by convert.gnn_params_from_jax. The JAX side
runs with impl="dense" and with impl="pallas" (the max kernel in interpret
mode). Tolerances:
  * "exact": rtol 1e-5, atol 1e-5 against impl="dense" (float32 matmuls
    summed in another order). Against impl="pallas" the max abs difference
    is within 2**-14 of the logits' scale: the JAX kernel's exact mode
    carries each gathered value as two bf16 halves (~2**-16 relative), and
    three layers amplify that (the JAX suite's own pallas-vs-dense model
    tolerance is 5e-3, tests/test_pallas_agg.py);
  * "fast": bf16 activations in both packages, rounded at different places:
    max abs difference within 2e-2 of the logits' scale, and at least 99%
    of the real nodes with the same argmax.
"""

import math

import jax
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxGraphSage
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import gnn_params_from_jax, gnn_params_to_jax
from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

N_NODES = 300


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    feats, src, dst, _ = random_graph(rng, N_NODES, avg_deg=5, f_dim=20)
    jg = jax_graph_from_arrays(feats, src, dst).with_tiled_aux()
    tg = graph_from_arrays(feats, src, dst)
    jmodel = JaxGraphSage(20, [32, 32], 4, "pool")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = gnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)).eval()
    return jg, tg, jmodel, jparams, model


def test_graph_tables_match(shared):
    jg, tg, *_ = shared
    assert np.array_equal(tg.nbr.numpy(), np.asarray(jg.nbr))
    assert np.array_equal(tg.nbr_mask.numpy(), np.asarray(jg.nbr_mask))
    assert np.array_equal(tg.feats.numpy(), np.asarray(jg.feats))
    assert int(tg.n_nodes[0]) == N_NODES and tg.nbr.dtype == torch.int32


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_gspool_exact_matches_jax(shared, impl):
    jg, tg, jmodel, jparams, model = shared
    with jax_precision("exact"):
        want = np.asarray(jmodel.apply(jparams, jg, impl=impl))
    with precision_scope("exact"), torch.inference_mode():
        got = model(tg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if impl == "dense":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2 ** -14 * np.abs(want).max()


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_gspool_fast_matches_jax(shared, impl):
    jg, tg, jmodel, jparams, model = shared
    with jax_precision("fast"):
        want = np.asarray(jmodel.apply(jparams, jg, impl=impl))[0, :N_NODES]
    with precision_scope("fast"), torch.inference_mode():
        got = model(tg).numpy()[0, :N_NODES]
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree


def test_params_round_trip(shared):
    *_, jparams, model = shared
    back = gnn_params_to_jax(model)
    for lp_j, lp_t in zip(jparams, back):
        assert set(lp_j) == set(lp_t)
        for k in lp_j:
            assert np.array_equal(np.asarray(lp_j[k]), lp_t[k])


def test_init_bounds_match_jax_initializers():
    """The port draws its own weights (torch.Generator) within the JAX
    package's bounds: xavier_uniform with gain sqrt(2), zero biases."""
    hp = HyperParams(layer_sizes=[64, 64])
    model = init_graph_net("GSpool", hp, torch.Generator().manual_seed(0))
    assert [layer.w_self.shape[1] for layer in model.layers] == [64, 64, 4]
    for layer in model.layers:
        for name in ("w_self", "w_neigh", "w_pool"):
            w = getattr(layer, name).detach()
            bound = math.sqrt(2.0) * math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
        assert not layer.bias.any() and not layer.b_pool.any()
    # GAT builds too, within the same bounds (attention vectors: fan_in =
    # heads, fan_out = features), its parameters in JAX flatten order
    hp.gat_heads, hp.gat_residuals = [4, 3], [False, True]
    gat = init_graph_net("GAT", hp, torch.Generator().manual_seed(0))
    assert [list(layer.keys) for layer in gat.layers] == [
        ["attn_l", "attn_r", "bias", "w"],
        ["attn_l", "attn_r", "bias", "w", "w_res"],
        ["attn_l", "attn_r", "bias", "w"]]
    assert [tuple(p.shape) for p in gat.jax_parameters()[:4]] == [
        (4, 64), (4, 64), (256,), (20, 256)]
    for layer in gat.layers:
        for name in ("w", "attn_l", "attn_r"):
            w = getattr(layer, name).detach()
            bound = math.sqrt(2.0) * math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            assert w.abs().max() <= bound and w.abs().max() > 0.5 * bound
        assert not layer.bias.any()


def test_dropout_only_in_training(shared):
    _, tg, _, _, model = shared
    model.dropout = 0.5
    try:
        with torch.inference_mode():
            a = model(tg)
            b = model(tg)
            c = model(tg, train=True, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.equal(a, c)
    finally:
        model.dropout = 0.0
