"""Synthetic supervoxel-graph data for tests and benchmarks.

Generates BraTS-shaped problems without BraTS data: a voxel volume partitioned
into grid "supervoxels" with jittered centroids, a spherical "tumor" labelling,
quantile-style node features correlated with labels, and kNN adjacency — i.e. the
same data contracts as the real preprocessing output (SURVEY §2.5), end to end:
graph + supervoxel partition volume + voxel labels.

A copy of gnn_tumor_seg_tpu/data/synthetic.py making the same numpy draws,
so one seed gives the same graphs in both packages; the port's graphs carry
the reciprocal slots training needs.
"""

from __future__ import annotations

import numpy as np

from ..ops.graph import GraphBatch, graph_from_arrays
from .image import project_nodes_to_img

__all__ = ["SyntheticGraphDataset", "make_synthetic_sample", "random_graph"]


def random_graph(rng: np.random.Generator, n_nodes: int, avg_deg: int = 5,
                 f_dim: int = 7):
    """Random undirected edge-list graph (both directions stored, parallel
    edges deduped, isolated nodes possible) — the standard small synthetic
    graph for tests and benchmarks.

    Returns (feats [N,F] f32, src, dst, labels [N] i32)."""
    m = max(1, n_nodes * avg_deg // 2)
    a = rng.integers(0, n_nodes, m)
    b = rng.integers(0, n_nodes, m)
    keep = a != b
    a, b = a[keep], b[keep]
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    feats = rng.normal(size=(n_nodes, f_dim)).astype(np.float32)
    labels = rng.integers(0, 4, n_nodes).astype(np.int32)
    return feats, src, dst, labels


def _knn_edges(centroids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    d2 = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :k]
    src = nbrs.reshape(-1)
    dst = np.repeat(np.arange(len(centroids)), k)
    # symmetrize (undirected)
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def make_synthetic_sample(rng: np.random.Generator, grid: int = 6, cell: int = 4,
                          k: int = 6, n_feats: int = 20):
    """Returns (feats [N,F], src, dst, labels [N], sv_partition volume, voxel_labels)."""
    side = grid * cell
    n = grid ** 3
    # jittered centroids of grid cells
    base = (np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"), -1)
            .reshape(-1, 3) + 0.5) * cell
    centroids = base + rng.normal(0, 0.3, base.shape)
    # spherical tumor: class by distance from a random center
    center = rng.uniform(0.3 * side, 0.7 * side, 3)
    dist = np.linalg.norm(centroids - center, axis=1)
    r = side * 0.30
    labels = np.zeros(n, np.int32)
    labels[dist < r] = 1
    labels[dist < r * 0.66] = 2
    labels[dist < r * 0.33] = 3
    # features: class-dependent means + noise, arranged like 5 quantiles x 4 mods
    class_means = rng.normal(0, 1.0, (4, n_feats))
    feats = class_means[labels] + rng.normal(0, 0.3, (n, n_feats))
    feats = feats.astype(np.float32)
    src, dst = _knn_edges(centroids, k)
    # supervoxel partition: voxel -> owning grid cell
    ix = np.arange(side) // cell
    sv = (ix[:, None, None] * grid * grid + ix[None, :, None] * grid
          + ix[None, None, :]).astype(np.int16)
    # carve a background margin (-1) like the brain crop leaves around the brain
    sv[0, :, :] = -1
    voxel_labels = project_nodes_to_img(sv, labels).astype(np.int16)
    return feats, src, dst, labels, sv, voxel_labels


class SyntheticGraphDataset:
    """In-memory dataset satisfying the trainer's data protocol:
    __len__, ids, get_graph(i), get_supervoxel_partitioning(id),
    get_voxel_labels(id), shape_budget()."""

    def __init__(self, n_samples: int = 8, grid: int = 6, cell: int = 4,
                 k: int = 6, n_feats: int = 20, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.ids = [f"synth_{i:03d}" for i in range(n_samples)]
        self._graphs: list[GraphBatch] = []
        self._svs = {}
        self._voxlabs = {}
        for mri_id in self.ids:
            feats, src, dst, labels, sv, voxlab = make_synthetic_sample(
                rng, grid=grid, cell=cell, k=k, n_feats=n_feats
            )
            self._graphs.append(graph_from_arrays(feats, src, dst, labels,
                                                  rslot=True))
            self._svs[mri_id] = sv
            self._voxlabs[mri_id] = voxlab

    def __len__(self):
        return len(self.ids)

    def get_graph(self, i: int) -> GraphBatch:
        return self._graphs[i]

    def get_supervoxel_partitioning(self, mri_id: str) -> np.ndarray:
        return self._svs[mri_id]

    def get_voxel_labels(self, mri_id: str) -> np.ndarray:
        return self._voxlabs[mri_id]

    def shape_budget(self):
        return (
            max(g.num_nodes_padded for g in self._graphs),
            max(g.max_degree for g in self._graphs),
        )
