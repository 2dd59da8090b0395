"""MRI volume -> supervoxel graph construction.

Capability match for `mri2graph/graphgen.py` (img2graph and helpers), redesigned
for throughput: the reference computes per-supervoxel quantiles via
scipy.labeled_comprehension with a Python callback per (segment x modality)
(~60k Python calls per brain, `graphgen.py:99-102`); here segment statistics are
fully vectorized (one lexsort + searchsorted interpolation per modality), and the
mode/centroid reductions are bincounts.

Pipeline per sample (mirrors `graphgen.py:240-267`):
  SLIC partition -> per-supervoxel features (5 quantiles/modality), mode label,
  centroid -> discard empty (background) supervoxels + renumber -> adjacency
  (kNN over centroids with regularity enforcement, or voxel contiguity with
  self-loops) -> GraphSample.

A copy of gnn_tumor_seg_tpu/data/graph_build.py, with spans (spans.py)
around its stages: the port imports nothing of the JAX package, and its
features and edge order must equal the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import spans
from .slic import slic_supervoxels

__all__ = [
    "GraphSample", "build_graph_sample", "sample_from_partition",
    "segment_quantiles", "segment_mode", "segment_centroids",
    "discard_empty_supervoxels", "knn_adjacency_edges", "contiguity_edges",
    "QUANTILES",
]

QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)   # graphgen.py:24


@dataclasses.dataclass
class GraphSample:
    """Host-side preprocessed sample: everything the training/eval path needs."""

    feats: np.ndarray          # f32 [N, F]
    labels: np.ndarray | None  # int32 [N]
    centroids: np.ndarray      # f32 [N, 3]
    src: np.ndarray            # int32 [E] (both directions for undirected)
    dst: np.ndarray            # int32 [E]
    sv_partition: np.ndarray   # int16 volume, -1 = background
    edge_weights: np.ndarray | None = None  # f32 [E], aligned with src/dst
    # raw SLIC label -> node id (-1 = discarded background supervoxel); lets
    # the serve path ship the raw partition to the device before the
    # renumbering is known and apply the remap there (cli/common.py)
    sv_remap: np.ndarray | None = None      # int32 [n_sv_raw]

    @property
    def n_nodes(self) -> int:
        return self.feats.shape[0]

    @property
    def n_edges(self) -> int:
        return len(self.src)


def _segment_sort(values: np.ndarray, segments: np.ndarray, n_seg: int):
    """Sort values within segments; returns (sorted_values, start_offsets[n_seg+1])."""
    order = np.lexsort((values, segments))
    sv = values[order]
    counts = np.bincount(segments, minlength=n_seg)
    offsets = np.concatenate(([0], np.cumsum(counts)))
    return sv, offsets, counts


def segment_quantiles(values: np.ndarray, segments: np.ndarray, n_seg: int,
                      quantiles=QUANTILES) -> np.ndarray:
    """Per-segment quantiles with linear interpolation (numpy 'linear' method).

    values, segments: flat arrays of equal length. Returns [n_seg, len(quantiles)];
    empty segments get 0.
    """
    sv, offsets, counts = _segment_sort(values, segments, n_seg)
    q = np.asarray(quantiles, np.float64)
    pos = (counts[:, None] - 1) * q[None, :]          # [n_seg, Q]
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    base = offsets[:-1][:, None]
    nonempty = counts > 0
    lo_i = base + np.clip(lo, 0, None)
    hi_i = base + np.clip(hi, 0, None)
    out = np.zeros((n_seg, len(quantiles)), np.float32)
    lo_v = sv[np.where(nonempty[:, None], lo_i, 0)]
    hi_v = sv[np.where(nonempty[:, None], hi_i, 0)]
    out = (lo_v * (1 - frac) + hi_v * frac).astype(np.float32)
    out[~nonempty] = 0.0
    return out


def segment_mode(values: np.ndarray, segments: np.ndarray, n_seg: int,
                 n_values: int) -> np.ndarray:
    """Per-segment modal value for small integer value ranges (labels 0..n_values-1)."""
    joint = segments.astype(np.int64) * n_values + values.astype(np.int64)
    counts = np.bincount(joint, minlength=n_seg * n_values).reshape(n_seg, n_values)
    return counts.argmax(1).astype(np.int32)


def segment_centroids(shape, segments: np.ndarray, n_seg: int) -> np.ndarray:
    """Per-segment centroid (uniform-mass center, `graphgen.py:60`)."""
    X, Y, Z = shape
    coords = np.stack(np.meshgrid(
        np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"), -1
    ).reshape(-1, 3).astype(np.float32)
    counts = np.maximum(np.bincount(segments, minlength=n_seg), 1).astype(np.float32)
    return np.stack(
        [np.bincount(segments, coords[:, d], n_seg) for d in range(3)], -1
    ) / counts[:, None]


def discard_empty_supervoxels(sv: np.ndarray, feats: np.ndarray,
                              centroids: np.ndarray, labels: np.ndarray):
    """Drop background supervoxels and renumber the rest contiguously.

    A supervoxel is background when its top quantile in the first modality sits at
    the global minimum (same 'black box' rule as `graphgen.py:71-90`: column 4 is
    the 0.9-quantile of modality 0). Background voxels become -1 in the partition.
    """
    top_q = feats[:, len(QUANTILES) - 1]
    empty = top_q < top_q.min() + 0.01
    remap = np.full(len(feats), -1, np.int32)
    remap[~empty] = np.arange(int((~empty).sum()), dtype=np.int32)
    new_partition = remap[sv].astype(np.int16)
    return new_partition, feats[~empty], centroids[~empty], labels[~empty], remap


def intensity_edge_weights(feats: np.ndarray, src: np.ndarray,
                           dst: np.ndarray, sigma: float = 0.1) -> np.ndarray:
    """Gaussian similarity weights per edge from node feature distances.

    Capability match for the weighted adjacency option of
    `graphgen.py:120-153` (weighted=True): distances normalized by the max,
    then w = exp(-d^2 / (2 sigma^2)). Computed per edge instead of as an
    O(N^2) cdist; the normalizer is therefore the max over *edges* rather than
    over all pairs (a scale factor inside the Gaussian — the reference never
    consumes these downstream anyway; img2graph passes weighted=False).
    Weights are symmetric (w_uv == w_vu), which the scatter-free weighted
    backward in ops/aggregate.py relies on."""
    d = np.linalg.norm(feats[src] - feats[dst], axis=1)
    d_all = d / max(float(d.max()), 1e-12)
    return np.exp(-(d_all ** 2) / (2 * sigma ** 2)).astype(np.float32)


def knn_adjacency_edges(centroids: np.ndarray, k: int,
                        enforce_regularity: bool = True,
                        use_native: bool | str = "auto"):
    """kNN adjacency over centroids -> undirected edge list (both directions).

    enforce_regularity mirrors `graphgen.py:120-135`: process nodes in index
    order; each node tops up its degree to k using its nearest not-yet-linked
    higher-index neighbors, and edges are symmetric — so nearly all nodes end with
    exactly k edges. No self-loops. With enforce_regularity=False every node
    simply links its k nearest (degree >= k after symmetrization).

    The numpy path materializes the O(n^2) distance matrix + full argsorts
    (~80s at BraTS scale on 2 cores); the native path streams distance rows
    with partial selection (use_native='auto' when the library is built).
    """
    n = len(centroids)
    if enforce_regularity and use_native in ("auto", True):
        from . import native

        if native.available():
            return native.knn_regular_native(centroids, k)
        if use_native is True:
            raise RuntimeError("native kNN requested but libgts_native unavailable")
    d2 = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1)
    adj = np.zeros((n, n), bool)
    if enforce_regularity:
        for i in range(n):
            deficit = k - int(adj[i].sum())
            if deficit <= 0:
                continue
            later = order[i][order[i] > i]
            chosen = later[:deficit]
            adj[i, chosen] = True
            adj[chosen, i] = True
    else:
        cols = order[:, :k]
        rows = np.repeat(np.arange(n), k)
        adj[rows, cols.reshape(-1)] = True
        adj |= adj.T
    dst, src = np.nonzero(adj)
    return src.astype(np.int32), dst.astype(np.int32)


def contiguity_edges(partition: np.ndarray, n_nodes: int,
                     self_loops: bool = True):
    """Edges between supervoxels that touch along any axis (+ self-loops),
    mirroring `graphgen.py:161-196` (including its diagonal fill at :189).
    partition: int volume with -1 background."""
    pairs = []
    for axis in range(3):
        a = np.moveaxis(partition, axis, 0)[:-1].reshape(-1)
        b = np.moveaxis(partition, axis, 0)[1:].reshape(-1)
        diff = a != b
        pairs.append(np.stack([a[diff], b[diff]], 1))
    p = np.concatenate(pairs)
    p = p[(p >= 0).all(1)]                 # drop background pairs
    p = np.unique(np.sort(p, axis=1), axis=0)  # undirected unique
    src = np.concatenate([p[:, 0], p[:, 1]])
    dst = np.concatenate([p[:, 1], p[:, 0]])
    if self_loops:
        loops = np.arange(n_nodes, dtype=p.dtype)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    return src.astype(np.int32), dst.astype(np.int32)


def build_graph_sample(
    voxel_intensities: np.ndarray,
    voxel_labels: np.ndarray | None,
    approx_num_nodes: int = 5000,
    boxiness: float = 0.5,
    k: int | None = 10,
    slic_fn=None,
    weighted: bool = False,
    stage_times: dict | None = None,
) -> GraphSample:
    """Full image -> graph conversion (reference: img2graph, `graphgen.py:240-267`).

    k > 0: regular kNN adjacency on centroids. k in (0, None): contiguity
    adjacency with self-loops. slic_fn allows substituting the TPU SLIC.
    weighted=True attaches Gaussian intensity-similarity edge weights (the
    reference's weighted-adjacency option, `graphgen.py:142-150`, which its
    pipeline computes but never passes — img2graph hardcodes weighted=False).
    stage_times, when given, gains the seconds of `slic_host` (the SLIC
    call, with its connectivity pass) and those sample_from_partition adds.
    """
    multi = voxel_intensities.ndim == 4
    img = voxel_intensities if multi else voxel_intensities[..., None]
    slic_fn = slic_fn or slic_supervoxels
    with spans.span("serve.slic_host", stage_times, "slic_host"):
        sv = slic_fn(img, n_segments=approx_num_nodes, compactness=boxiness,
                     sigma=1.0)
    return sample_from_partition(img, voxel_labels, sv, k, weighted=weighted,
                                 stage_times=stage_times)


def sample_from_partition(
    img: np.ndarray,
    voxel_labels: np.ndarray | None,
    sv: np.ndarray,
    k: int | None,
    weighted: bool = False,
    feat_affine: tuple[np.ndarray, np.ndarray] | None = None,
    stage_times: dict | None = None,
) -> GraphSample:
    """Partition -> GraphSample: segment stats, background discard, adjacency.

    The tail of `build_graph_sample` (reference `graphgen.py:29-32,240-267`
    after SLIC), exposed so a caller that already holds a final supervoxel
    partition (e.g. the device-SLIC serve path) can finish graph construction.

    feat_affine=(a[C], b[C]) maps per-modality quantile features y = a_c*q + b_c
    after computing them on `img`. Quantiles with linear interpolation commute
    with positive affine maps, so passing the RAW image plus the
    normalize/standardize affine (a = 1/(q995*std), b = -mean/std) yields the
    standardized-space features without materializing a standardized volume on
    the host — the device-preprocess serve path's contract
    (ops/slic_tpu.serve_preprocess_tpu).

    stage_times, when given, gains the seconds of `stats` (segment
    quantiles, mode and centroids, the affine and the discard) and `knn`
    (knn_adjacency_edges)."""
    labels_provided = voxel_labels is not None
    with spans.span("serve.stats", stage_times, "stats"):
        n_sv = int(sv.max()) + 1
        if not labels_provided:
            voxel_labels = np.zeros(img.shape[:3], np.int16)

        flat_sv = sv.reshape(-1)
        n_classes = max(int(voxel_labels.max()) + 1, 1)
        from . import native

        if native.available():
            feats = np.concatenate(
                [native.segment_quantiles_native(img[..., c].reshape(-1), flat_sv,
                                                 n_sv, QUANTILES)
                 for c in range(img.shape[-1])], axis=1
            )
            sv_labels = native.segment_mode_native(
                voxel_labels.reshape(-1).astype(np.int16), flat_sv, n_sv, n_classes
            )
            sv_centroids = native.segment_centroids_native(sv.astype(np.int32), n_sv)
        else:
            feats = np.concatenate(
                [segment_quantiles(img[..., c].reshape(-1), flat_sv, n_sv)
                 for c in range(img.shape[-1])], axis=1
            )
            sv_labels = segment_mode(voxel_labels.reshape(-1), flat_sv, n_sv,
                                     n_classes)
            sv_centroids = segment_centroids(sv.shape, flat_sv, n_sv)

        if feat_affine is not None:
            a, b = feat_affine
            nq = len(QUANTILES)
            feats = feats.astype(np.float32)
            for c in range(img.shape[-1]):
                feats[:, c * nq:(c + 1) * nq] *= np.float32(a[c])
                feats[:, c * nq:(c + 1) * nq] += np.float32(b[c])

        partition, feats, centroids, labels, sv_remap = discard_empty_supervoxels(
            sv, feats, sv_centroids, sv_labels
        )
    n_nodes = feats.shape[0]
    if k:
        with spans.span("serve.knn", stage_times, "knn"):
            src, dst = knn_adjacency_edges(centroids, k)
    else:
        src, dst = contiguity_edges(partition, n_nodes)
    edge_weights = None
    if weighted:
        edge_weights = intensity_edge_weights(feats.astype(np.float32), src, dst)
    return GraphSample(
        feats=feats.astype(np.float32),
        labels=labels.astype(np.int32) if labels_provided else None,
        centroids=centroids,
        src=src, dst=dst,
        sv_partition=partition,
        edge_weights=edge_weights,
        sv_remap=sv_remap,
    )
