"""Reciprocal slots and batching: the port's host tables against the JAX package's.

`reciprocal_slots` must equal `build_tiled_aux(...).rslot`
(gnn_tumor_seg_tpu/ops/pallas/tiling.py:71) exactly, and must raise where
`build_tiled_aux` silently returns a wrong table: a directed edge (no
reciprocal) or a neighbour named twice in a row. `batch_graphs` must stack
and repad like the JAX package's, carrying rslot and edge weights.
"""

import numpy as np
import pytest

from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.ops.graph import batch_graphs as jax_batch_graphs
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.tiling import build_tiled_aux
from gnn_tumor_seg_tpu_torch.ops.graph import (batch_graphs, ell_from_edges,
                                               graph_from_arrays, masked_copy,
                                               reciprocal_slots)


def _symmetric_graph(seed, n=120, avg_deg=6, self_loops=True):
    rng = np.random.default_rng(seed)
    feats, src, dst, labels = random_graph(rng, n, avg_deg=avg_deg, f_dim=5)
    if self_loops:                      # contiguity graphs carry them
        loops = rng.choice(n, n // 4, replace=False)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return feats, src, dst, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_rslot_equals_jax_tiling_table(seed):
    tables = [ell_from_edges(120, *_symmetric_graph(seed + 10 * b)[1:3],
                             n_pad=128, d_pad=24) for b in range(2)]
    nbr = np.stack([t[0] for t in tables])
    mask = np.stack([t[1] for t in tables])
    assert (mask.sum(-1) == 0).any()      # isolated and padded rows included
    want = build_tiled_aux(nbr, mask, tile=64).rslot
    got = reciprocal_slots(nbr, mask)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want))
    # the defining property, on every real slot
    b, u, d = np.nonzero(mask)
    v = nbr[b, u, d]
    assert np.array_equal(nbr[b, v, got[b, u, d]], u)


def test_rslot_refuses_directed_and_duplicated_tables():
    _, src, dst, _ = _symmetric_graph(3, self_loops=False)
    directed = (src != src[0]) | (dst != dst[0])        # drop one direction
    nbr, mask = ell_from_edges(120, src[directed], dst[directed], n_pad=128)
    with pytest.raises(ValueError, match="no reciprocal"):
        reciprocal_slots(nbr[None], mask[None])
    dup_src = np.concatenate([src, src[:1], dst[:1]])
    dup_dst = np.concatenate([dst, dst[:1], src[:1]])
    nbr, mask = ell_from_edges(120, dup_src, dup_dst, n_pad=128)
    with pytest.raises(ValueError, match="more than once"):
        reciprocal_slots(nbr[None], mask[None])


def test_batch_graphs_matches_jax_and_carries_rslot():
    graphs, jgraphs = [], []
    for seed, n in ((0, 90), (1, 120)):
        feats, src, dst, labels = _symmetric_graph(seed, n=n)
        w = np.random.default_rng(seed).random(len(src)).astype(np.float32)
        graphs.append(graph_from_arrays(feats, src, dst, labels, edge_weights=w,
                                        rslot=True))
        jgraphs.append(jax_graph_from_arrays(feats, src, dst, labels,
                                             edge_weights=w))
    batch = batch_graphs(graphs, n_pad=256, d_pad=24)
    want = jax_batch_graphs(jgraphs, n_pad=256, d_pad=24)
    for name in ("nbr", "nbr_mask", "node_mask", "feats", "labels", "n_nodes",
                 "edge_weight"):
        assert np.array_equal(getattr(batch, name).numpy(),
                              np.asarray(getattr(want, name))), name
    assert np.array_equal(batch.rslot.numpy(),
                          reciprocal_slots(batch.nbr.numpy(),
                                           batch.nbr_mask.numpy()))
    pad = masked_copy(graphs[0])
    assert not pad.node_mask.any() and not pad.nbr_mask.any()
    assert (pad.labels == -1).all() and int(pad.n_nodes[0]) == 0
    assert batch_graphs([graphs[0], pad]).rslot is not None
    assert batch_graphs([graphs[0], graphs[1].replace(rslot=None)]).rslot is None
