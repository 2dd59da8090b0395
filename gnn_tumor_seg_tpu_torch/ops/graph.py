"""Batched graph container: the JAX package's dense padded neighbour-list ("ELL")
layout, as torch tensors.

  nbr       int32  [B, N, D]   src node index for each (dst, slot); padded slots -> 0
  nbr_mask  f32    [B, N, D]   1.0 where a real edge exists
  node_mask f32    [B, N]      1.0 where a real node exists
  feats     f32    [B, N, F]   node features (padded rows are zero)
  labels    int32  [B, N]      optional node labels (padded rows are -1)
  n_nodes   int32  [B]         real node count per graph
  edge_weight f32  [B, N, D]   optional weight of the edge in each slot
  rslot     int32  [B, N, D]   optional reciprocal slots (training): for the
                               edge u -> v stored at nbr[u, d] = v, the slot j
                               with nbr[v, j] == u (padded slots 0)

Counterpart of gnn_tumor_seg_tpu/ops/graph.py. The slot order within each row
is the JAX package's exactly (a stable sort of the COO edges by destination):
the max-aggregation kernel reports the FIRST slot that attains the max, so a
different order would change which slot wins. The TPU tile-compaction tables
(`tiled`: uniq/lidx) have no counterpart: the Hopper kernels read `nbr`
directly. Of them only `rslot` is kept (ops/pallas/tiling.py:126-143), which
routes the max gradient through the winner slots without a scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "GraphBatch",
    "ell_from_edges",
    "graph_from_arrays",
    "batch_graphs",
    "masked_copy",
    "reciprocal_slots",
    "bucket_size",
    "NODE_BUCKETS",
    "DEGREE_BUCKETS",
]

# Node-count buckets: BraTS supervoxel graphs are ~5-7k nodes; the buckets are
# the JAX package's, so both packages pad a graph to the same shape.
NODE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 6144, 8192, 12288, 16384)
# Max-degree buckets: the default kNN graphs (k=10 with regularity
# enforcement) have max degree 10-12. D <= 128 lets the kernel store winner
# slots as uint8.
DEGREE_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128)


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; rounds up to a multiple of the largest bucket if oversize."""
    for b in buckets:
        if n <= b:
            return b
    step = buckets[-1]
    return ((n + step - 1) // step) * step


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A batch of B padded graphs; single graphs are B=1 batches. `labels`
    is None when ground truth is unavailable (serving); `rslot` is None
    unless the graph was built for training (graph_from_arrays(rslot=True))."""

    nbr: torch.Tensor
    nbr_mask: torch.Tensor
    node_mask: torch.Tensor
    feats: torch.Tensor
    labels: torch.Tensor | None
    n_nodes: torch.Tensor
    edge_weight: torch.Tensor | None = None
    rslot: torch.Tensor | None = None

    @property
    def num_nodes_padded(self) -> int:
        return self.nbr.shape[1]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[2]

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        """The same graph with every tensor on `device`."""
        return GraphBatch(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


def ell_from_edges(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    n_pad: int | None = None,
    d_pad: int | None = None,
    edge_vals: np.ndarray | None = None,
):
    """Host-side: COO edge list -> padded neighbor table.

    For each destination node, collects the source endpoints of its in-edges
    in COO order (edges of undirected graphs are stored in both directions).
    Returns (nbr int32 [n_pad, d_pad], nbr_mask float32 [n_pad, d_pad]); with
    edge_vals (a float per COO edge, e.g. weights), a third float32
    [n_pad, d_pad] table slotted identically.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    counts = np.bincount(dst, minlength=n_nodes)
    max_deg = int(counts.max()) if len(dst) else 0
    if n_pad is None:
        n_pad = bucket_size(n_nodes, NODE_BUCKETS)
    if d_pad is None:
        d_pad = bucket_size(max(max_deg, 1), DEGREE_BUCKETS)
    if max_deg > d_pad:
        raise ValueError(f"max degree {max_deg} exceeds degree padding {d_pad}")
    if n_nodes > n_pad:
        raise ValueError(f"n_nodes {n_nodes} exceeds node padding {n_pad}")
    if len(src) and (src.min() < 0 or src.max() >= n_nodes):
        raise ValueError(f"edge source outside [0, {n_nodes})")

    nbr = np.zeros((n_pad, d_pad), dtype=np.int32)
    mask = np.zeros((n_pad, d_pad), dtype=np.float32)
    # Stable fill: sort edges by dst, then slot edges per dst in order.
    order = np.argsort(dst, kind="stable")
    s_sorted = src[order]
    d_sorted = dst[order]
    slot = np.arange(len(d_sorted)) - np.repeat(
        np.concatenate(([0], np.cumsum(counts)[:-1])), counts
    )
    nbr[d_sorted, slot] = s_sorted
    mask[d_sorted, slot] = 1.0
    if edge_vals is not None:
        vals = np.zeros((n_pad, d_pad), dtype=np.float32)
        vals[d_sorted, slot] = np.asarray(edge_vals, np.float32)[order]
        return nbr, mask, vals
    return nbr, mask


def reciprocal_slots(nbr: np.ndarray, nbr_mask: np.ndarray) -> np.ndarray:
    """Host-side: rslot int32 [B, N, D] for nbr/nbr_mask [B, N, D]. For the
    edge u -> v at nbr[u, d] = v, rslot[u, d] is the slot j of row v with
    nbr[v, j] == u; padded slots get 0.

    The algorithm of gnn_tumor_seg_tpu/ops/pallas/tiling.py:126-143 (sort each
    row once, then one searchsorted over the row-offset id space), plus the
    checks it leaves out: raises ValueError when a row names a neighbour
    twice or a real slot has no reciprocal, since a directed or duplicated
    table would route max gradients wrongly without any error."""
    nbr = np.asarray(nbr)
    mask = np.asarray(nbr_mask) > 0
    B, N, D = nbr.shape
    sent = np.int64(N + 1)           # > any real id; marks padded slots
    k = int(sent) + 1
    rslot = np.zeros((B, N, D), np.int32)
    u_ids = np.arange(N, dtype=np.int64)[:, None]
    for b in range(B):
        ids = np.where(mask[b], nbr[b].astype(np.int64), sent)
        order = np.argsort(ids, axis=1, kind="stable").astype(np.int32)
        snbr = np.take_along_axis(ids, order, axis=1)   # rows sorted
        dup = (snbr[:, 1:] == snbr[:, :-1]) & (snbr[:, 1:] != sent)
        if dup.any():
            u = int(np.nonzero(dup.any(axis=1))[0][0])
            raise ValueError(f"graph {b}: row {u} names a neighbour more than "
                             "once; the table must be deduplicated")
        flat = (snbr + u_ids * k).reshape(-1)           # globally sorted
        v = np.where(mask[b], nbr[b], 0).astype(np.int64)
        q = v * k + u_ids                               # find u in row v
        p = np.minimum(np.searchsorted(flat, q.reshape(-1)), N * D - 1)
        j_sorted = np.minimum(p - (p // D) * D, D - 1).reshape(N, D)
        j = order[v, j_sorted]                          # slot in row v
        found = (nbr[b][v, j] == u_ids) & mask[b][v, j]
        missing = mask[b] & ~found
        if missing.any():
            u, d = (int(x[0]) for x in np.nonzero(missing))
            raise ValueError(
                f"graph {b}: edge {u} -> {int(nbr[b][u, d])} (slot {d}) has no "
                "reciprocal edge; the table must be symmetric")
        rslot[b] = np.where(mask[b], j, 0)
    return rslot


def graph_from_arrays(
    feats: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    labels: np.ndarray | None = None,
    n_pad: int | None = None,
    d_pad: int | None = None,
    edge_weights: np.ndarray | None = None,
    rslot: bool = False,
) -> GraphBatch:
    """Host-side: build a B=1 GraphBatch (CPU tensors) from numpy node
    features + COO edges; `.to(device)` moves it to the card.

    edge_weights (optional, one float per COO edge) lands on the slotted
    edge_weight table. rslot=True builds the reciprocal slots that training
    through max aggregation needs (reciprocal_slots, which raises on a
    directed or duplicated edge list)."""
    n_nodes, f_dim = feats.shape
    w_tab = None
    if edge_weights is not None:
        nbr, mask, w_tab = ell_from_edges(n_nodes, src, dst, n_pad=n_pad,
                                          d_pad=d_pad, edge_vals=edge_weights)
    else:
        nbr, mask = ell_from_edges(n_nodes, src, dst, n_pad=n_pad, d_pad=d_pad)
    n_pad = nbr.shape[0]
    feats_p = np.zeros((n_pad, f_dim), dtype=np.float32)
    feats_p[:n_nodes] = feats
    node_mask = np.zeros((n_pad,), dtype=np.float32)
    node_mask[:n_nodes] = 1.0
    labels_t = None
    if labels is not None:
        labels_p = np.full((n_pad,), -1, dtype=np.int32)
        labels_p[:n_nodes] = labels
        labels_t = torch.from_numpy(labels_p)[None]
    return GraphBatch(
        nbr=torch.from_numpy(nbr)[None],
        nbr_mask=torch.from_numpy(mask)[None],
        node_mask=torch.from_numpy(node_mask)[None],
        feats=torch.from_numpy(feats_p)[None],
        labels=labels_t,
        n_nodes=torch.tensor([n_nodes], dtype=torch.int32),
        edge_weight=None if w_tab is None else torch.from_numpy(w_tab)[None],
        rslot=(torch.from_numpy(reciprocal_slots(nbr[None], mask[None]))
               if rslot else None),
    )


def masked_copy(g: GraphBatch) -> GraphBatch:
    """A padding graph that contributes nothing to the loss (no real node,
    no real edge, labels -1): fills a short batch to its fixed size
    (gnn_tumor_seg_tpu/train/gnn_trainer.py:39-48)."""
    return g.replace(
        node_mask=torch.zeros_like(g.node_mask),
        nbr_mask=torch.zeros_like(g.nbr_mask),
        labels=None if g.labels is None else torch.full_like(g.labels, -1),
        n_nodes=torch.zeros_like(g.n_nodes),
    )


def _pad_to(x: torch.Tensor, n: int, d: int | None = None, fill=0):
    pads = [0, 0] * x.dim()            # torch.nn.functional.pad order: last dim first
    pads[2 * (x.dim() - 2) + 1] = n - x.shape[1]
    if d is not None:
        pads[2 * (x.dim() - 3) + 1] = d - x.shape[2]
    return torch.nn.functional.pad(x, pads, value=fill)


def batch_graphs(graphs: Sequence[GraphBatch], n_pad: int | None = None,
                 d_pad: int | None = None) -> GraphBatch:
    """Stack graphs (each a batch, usually B=1) into one batch, padded to
    shared bucket shapes (gnn_tumor_seg_tpu/ops/graph.py:254-375, without
    the TPU tiling tables). Passing n_pad/d_pad pins the bucket. The tensors
    are concatenated where they lie, so graphs already on the card are
    batched there without a host round trip. edge_weight and rslot are kept
    when every graph carries them."""
    if n_pad is None:
        n_pad = bucket_size(max(g.num_nodes_padded for g in graphs), NODE_BUCKETS)
    if d_pad is None:
        d_pad = bucket_size(max(g.max_degree for g in graphs), DEGREE_BUCKETS)
    same = all(g.num_nodes_padded == n_pad and g.max_degree == d_pad
               for g in graphs)

    def cat(name: str, per_slot: bool = False, fill=0):
        xs = [getattr(g, name) for g in graphs]
        if any(x is None for x in xs):
            return None
        if not same:
            xs = [_pad_to(x, n_pad, d_pad if per_slot else None, fill)
                  for x in xs]
        return torch.cat(xs, dim=0)

    return GraphBatch(
        nbr=cat("nbr", per_slot=True),
        nbr_mask=cat("nbr_mask", per_slot=True),
        node_mask=cat("node_mask"),
        feats=cat("feats"),
        labels=cat("labels", fill=-1),
        n_nodes=torch.cat([g.n_nodes for g in graphs]),
        edge_weight=cat("edge_weight", per_slot=True),
        rslot=cat("rslot", per_slot=True),
    )
