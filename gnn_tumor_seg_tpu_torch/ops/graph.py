"""Batched graph container: the JAX package's dense padded neighbour-list ("ELL")
layout, as torch tensors.

  nbr       int32  [B, N, D]   src node index for each (dst, slot); padded slots -> 0
  nbr_mask  f32    [B, N, D]   1.0 where a real edge exists
  node_mask f32    [B, N]      1.0 where a real node exists
  feats     f32    [B, N, F]   node features (padded rows are zero)
  labels    int32  [B, N]      optional node labels (padded rows are -1)
  n_nodes   int32  [B]         real node count per graph

Counterpart of gnn_tumor_seg_tpu/ops/graph.py. The slot order within each row
is the JAX package's exactly (a stable sort of the COO edges by destination):
the max-aggregation kernel reports the FIRST slot that attains the max, so a
different order would change which slot wins. The TPU tile-compaction tables
(`tiled`: uniq/lidx) have no counterpart: the Hopper kernel reads `nbr`
directly.
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
    is None when ground truth is unavailable (serving)."""

    nbr: torch.Tensor
    nbr_mask: torch.Tensor
    node_mask: torch.Tensor
    feats: torch.Tensor
    labels: torch.Tensor | None
    n_nodes: torch.Tensor

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
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: COO edge list -> padded neighbor table.

    For each destination node, collects the source endpoints of its in-edges
    in COO order (edges of undirected graphs are stored in both directions).
    Returns (nbr int32 [n_pad, d_pad], nbr_mask float32 [n_pad, d_pad]).
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
    return nbr, mask


def graph_from_arrays(
    feats: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    labels: np.ndarray | None = None,
    n_pad: int | None = None,
    d_pad: int | None = None,
) -> GraphBatch:
    """Host-side: build a B=1 GraphBatch (CPU tensors) from numpy node
    features + COO edges; `.to(device)` moves it to the card."""
    n_nodes, f_dim = feats.shape
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
    )
