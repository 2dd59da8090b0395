"""Dataset -> PartitionedGraph glue for the halo regime (counterpart of
gnn_tumor_seg_tpu/parallel/halo_data.py; host numpy, copied).

The reference trains on minibatches of 6 disjoint-union graphs
(`model/gnn_model.py:12,34-48`); the halo regime keeps that union but lays
it out as one giant graph whose nodes are split contiguously over the ranks
(parallel/halo.py):

  build_partitioned_sets     chunk several index groups (train and val of a
                             fold) into unions and partition them all with
                             one (shard, degree, halo width) shape, so one
                             model covers every batch (p2p bakes its
                             exchange width into the model);
  build_partitioned_batches  the single-group wrapper;
  unpermute_nodes            per-node rows back in union order;
  PartitionedBatch           a partitioned union with the per-sample
                             bookkeeping evaluation needs.

Every rank builds the same unions (the data directory is the same for
all), and each then places only its own slice on its device. The JAX
package's Pallas tiling aux (`tiled`, `_common_aux_budget`) has no
counterpart: the Hopper kernels read the table directly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .halo import PartitionedGraph, partition_graph, partition_graph_p2p

__all__ = ["PartitionedBatch", "union_samples", "build_partitioned_sets",
           "build_partitioned_batches", "unpermute_nodes"]


@dataclasses.dataclass
class PartitionedBatch:
    """A partitioned disjoint-union graph and the metadata to undo it."""

    pg: PartitionedGraph
    variant: str                 # "all_gather" | "p2p"
    halo_width: int | None       # set iff variant == "p2p"
    sample_ids: list[str]        # mri ids of the union, in order
    offsets: np.ndarray          # int64 [B+1]: sample b's nodes are
                                 # [offsets[b], offsets[b+1]) in union order
    n_total: int                 # real (unpadded) nodes in the union


def union_samples(samples: Sequence):
    """Disjoint union of GraphSamples -> (feats, src, dst, labels_or_None,
    offsets [B+1], edge_weights_or_None); edge endpoints offset into the
    union's ids (the reference's `dgl.batch`)."""
    feats = np.concatenate([s.feats for s in samples], axis=0)
    offsets = np.zeros(len(samples) + 1, np.int64)
    offsets[1:] = np.cumsum([s.n_nodes for s in samples])
    src = np.concatenate(
        [s.src.astype(np.int64) + offsets[b] for b, s in enumerate(samples)])
    dst = np.concatenate(
        [s.dst.astype(np.int64) + offsets[b] for b, s in enumerate(samples)])
    labels = None
    if all(s.labels is not None for s in samples):
        labels = np.concatenate([s.labels for s in samples]).astype(np.int32)
    weights = None
    if all(getattr(s, "edge_weights", None) is not None for s in samples):
        weights = np.concatenate(
            [s.edge_weights for s in samples]).astype(np.float32)
    return feats.astype(np.float32), src, dst, labels, offsets, weights


def _collect_raw(dataset, indices: Sequence[int], graphs_per_batch: int):
    indices = list(indices)
    raw = []
    for i in range(0, len(indices), graphs_per_batch):
        chunk = indices[i:i + graphs_per_batch]
        samples = [dataset.get_sample(int(j)) for j in chunk]
        ids = [dataset.ids[int(j)] for j in chunk]
        raw.append((*union_samples(samples), ids))
    return raw


def _natural_shapes(n: int, dst, n_parts: int) -> tuple[int, int]:
    per = -(-n // n_parts)
    shard = -(-per // 8) * 8
    deg = np.bincount(dst, minlength=n)
    d_pad = -(-max(int(deg.max(initial=0)), 1) // 8) * 8
    return shard, d_pad


def build_partitioned_sets(dataset, n_parts: int, graphs_per_batch: int,
                           variant: str = "all_gather",
                           groups: Sequence[Sequence[int]] = (),
                           ) -> tuple[list[list[PartitionedBatch]], str,
                                      int | None]:
    """Partition several index groups with one common (shard, degree, halo)
    shape. variant="p2p" takes the boundary-only exchange where every
    union's edges allow it; if any chunk does not, every group falls back
    to all_gather, and this prints why (as the JAX package does).

    Returns (batches_per_group, variant_used, halo_width_or_None)."""
    if variant not in ("all_gather", "p2p"):
        raise ValueError(f"unknown halo variant {variant!r}")
    raws = [_collect_raw(dataset, g, graphs_per_batch) for g in groups]
    flat = [r for group in raws for r in group]

    shard_max = d_max = 1
    for feats, _, dst, *_ in flat:
        shard, d_pad = _natural_shapes(feats.shape[0], dst, n_parts)
        shard_max, d_max = max(shard_max, shard), max(d_max, d_pad)

    def build(partition):
        return [[partition(*raw) for raw in group] for group in raws]

    if variant == "p2p":
        # two passes: each chunk's natural W under the common pads, then
        # every chunk again at the largest, so one exchange width fits all
        try:
            w_max = 0
            for feats, src, dst, labels, *_ in flat:
                _, w = partition_graph_p2p(feats, src, dst, labels, n_parts,
                                           shard_pad_to=shard_max,
                                           d_pad_to=d_max)
                w_max = max(w_max, w)

            def p2p(feats, src, dst, labels, offsets, weights, ids):
                pg, w = partition_graph_p2p(feats, src, dst, labels, n_parts,
                                            shard_pad_to=shard_max,
                                            d_pad_to=d_max,
                                            halo_pad_to=w_max,
                                            edge_weights=weights)
                if w != w_max:
                    raise RuntimeError(f"halo width {w} != common {w_max}")
                return PartitionedBatch(pg, "p2p", w, ids, offsets,
                                        feats.shape[0])

            return build(p2p), "p2p", w_max
        except ValueError as e:
            print(f"halo p2p unavailable ({e}); falling back to all_gather")

    def ag(feats, src, dst, labels, offsets, weights, ids):
        pg = partition_graph(feats, src, dst, labels, n_parts,
                             shard_pad_to=shard_max, d_pad_to=d_max,
                             edge_weights=weights)
        return PartitionedBatch(pg, "all_gather", None, ids, offsets,
                                feats.shape[0])

    return build(ag), "all_gather", None


def build_partitioned_batches(dataset, n_parts: int, graphs_per_batch: int,
                              variant: str = "all_gather",
                              indices: Sequence[int] | None = None,
                              ) -> list[PartitionedBatch]:
    """Single-group wrapper around build_partitioned_sets."""
    if indices is None:
        indices = range(len(dataset))
    sets, _, _ = build_partitioned_sets(dataset, n_parts, graphs_per_batch,
                                        variant, [list(indices)])
    return sets[0]


def unpermute_nodes(x: np.ndarray, n_total: int) -> np.ndarray:
    """Undo the shard layout: [S, shard, ...] -> [n_total, ...] in union
    order (inverse of partition_graph's node -> padded-row map)."""
    x = np.asarray(x)
    n_parts, shard = x.shape[0], x.shape[1]
    flat = x.reshape(n_parts * shard, *x.shape[2:])
    per = -(-n_total // n_parts)
    ids = np.arange(n_total)
    return flat[(ids // per) * shard + (ids % per)]
