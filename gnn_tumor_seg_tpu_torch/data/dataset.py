"""On-disk dataset over preprocessed sample directories (counterpart of
gnn_tumor_seg_tpu/data/dataset.py's ImageGraphDataset; PredLogitDataset
comes with the refinement-CNN training slice).

Capability match for `data_processing/data_loader.py` (ImageGraphDataset)
with the same artifact layout per sample directory

    <root>/<mri_id>/<mri_id>_input.nii.gz          processed 4-modality image
                     <mri_id>_label.nii.gz          voxel labels (optional)
                     <mri_id>_supervoxels.nii.gz    partition volume (-1 = bg)
                     <mri_id>_crop.npy              brain crop indices
                     <mri_id>_graph.npz             binary graph (native format)
                     <mri_id>_nxgraph.json          node-link JSON (interop)

so data preprocessed by the reference pipeline loads here directly (JSON path)
and vice versa. Unlike the reference — which re-parses the JSON and rebuilds a
DGL graph *every epoch* (`data_loader.py:67-83`) — graphs are converted to padded
GraphBatch tensors once and cached in host memory. They carry the reciprocal
slots (`rslot`) that training through max aggregation needs; building them
raises on a directed or duplicated edge list.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..ops.graph import (DEGREE_BUCKETS, NODE_BUCKETS, GraphBatch, bucket_size,
                         graph_from_arrays)
from . import nifti, store
from .cache import LRUBytesCache

__all__ = ["ImageGraphDataset", "discover_sample_dirs"]


def discover_sample_dirs(root: str, prefix: str = "") -> dict[str, str]:
    """Find sample directories (id -> path), recursively, matching the
    reference's glob discovery (`data_loader.py:46-50`)."""
    pats = glob.glob(os.path.join(root, "**", f"{prefix}*") + os.sep, recursive=True)
    out = {}
    for fp in sorted(pats):
        mri_id = os.path.basename(os.path.normpath(fp))
        # a sample dir must contain at least one artifact named after itself
        if glob.glob(os.path.join(fp, f"{mri_id}_*")):
            out[mri_id] = fp
    return out


class ImageGraphDataset:
    def __init__(self, root: str, prefix: str = "", read_image: bool = True,
                 read_graph: bool = True, read_label: bool = True,
                 cache_graphs: bool = True, cache_bytes: int | None = None):
        if not (read_graph or read_image):
            raise ValueError("read_graph or read_image must be set")
        self.root = root
        self.read_image = read_image
        self.read_graph = read_graph
        self.read_label = read_label
        self._dirs = discover_sample_dirs(root, prefix)
        self.ids = list(self._dirs)
        print(f"Found {len(self.ids)} MRIs")
        # byte-bounded LRU (data/cache.py): at BraTS-2021 scale an unbounded
        # dict holds GBs of padded arrays; evicted graphs repad from disk
        self._cache = LRUBytesCache(cache_bytes) if cache_graphs else None
        self._budget = None

    def __len__(self):
        return len(self.ids)

    # ------------------------------------------------------------- paths
    def _fp(self, mri_id: str, suffix: str) -> str:
        return os.path.join(self._dirs[mri_id], f"{mri_id}{suffix}")

    # ------------------------------------------------------------- graphs
    def _load_sample(self, mri_id: str):
        npz = self._fp(mri_id, "_graph.npz")
        if os.path.exists(npz):
            return store.load_graph_npz(npz)
        return store.load_networkx_json(self._fp(mri_id, "_nxgraph.json"))

    def shape_budget(self) -> tuple[int, int]:
        if self._budget is None:
            n_max = d_max = 1
            for mri_id in self.ids:
                npz = self._fp(mri_id, "_graph.npz")
                if os.path.exists(npz):
                    n, d = store.peek_graph_npz(npz)
                else:
                    s = self._load_sample(mri_id)
                    n = s.n_nodes
                    d = int(np.bincount(s.dst, minlength=n).max()) if s.n_edges else 0
                n_max, d_max = max(n_max, n), max(d_max, d)
            self._budget = (bucket_size(n_max, NODE_BUCKETS),
                            bucket_size(d_max, DEGREE_BUCKETS))
        return self._budget

    def get_sample(self, i: int):
        """Raw (unpadded) GraphSample: feats/src/dst/labels arrays."""
        s = self._load_sample(self.ids[i])
        if not self.read_label:
            import dataclasses

            s = dataclasses.replace(s, labels=None)
        return s

    def get_graph(self, i: int) -> GraphBatch:
        mri_id = self.ids[i]
        if self._cache is not None:
            g = self._cache.get(mri_id)
            if g is not None:
                return g
        s = self._load_sample(mri_id)
        n_pad, d_pad = self.shape_budget()
        g = graph_from_arrays(
            s.feats, s.src, s.dst,
            labels=s.labels if self.read_label else None,
            n_pad=n_pad, d_pad=d_pad,
            edge_weights=s.edge_weights,
            rslot=True,
        )
        if self._cache is not None:
            self._cache.put(mri_id, g)
        return g

    # ------------------------------------------------------------- volumes
    def get_image(self, mri_id: str) -> np.ndarray:
        return nifti.read_nifti(self._fp(mri_id, "_input.nii.gz"), np.float32)

    def get_voxel_labels(self, mri_id: str) -> np.ndarray:
        return nifti.read_nifti(self._fp(mri_id, "_label.nii.gz"), np.int16)

    def get_supervoxel_partitioning(self, mri_id: str) -> np.ndarray:
        return nifti.read_nifti(self._fp(mri_id, "_supervoxels.nii.gz"), np.int16)

    def get_crop(self, mri_id: str):
        return tuple(np.load(self._fp(mri_id, "_crop.npy"), allow_pickle=True))

    # familiar container protocol (reference: data_loader.py:104-114)
    def __getitem__(self, index: int):
        mri_id = self.ids[index]
        out = [mri_id]
        if self.read_graph:
            out.append(self.get_graph(index))
        if self.read_image:
            out.append(self.get_image(mri_id))
            if self.read_label:
                out.append(self.get_voxel_labels(mri_id))
        return tuple(out)

    def __iter__(self):
        for i in range(len(self.ids)):
            yield self[i]

    def get_orig_shape(self, mri_id: str) -> tuple:
        """Original raw-volume shape; falls back to the BraTS standard shape for
        datasets preprocessed by the reference pipeline (no _meta.json)."""
        import json

        fp = self._fp(mri_id, "_meta.json")
        if os.path.exists(fp):
            with open(fp) as f:
                return tuple(json.load(f)["orig_shape"])
        from .image import BRATS_SHAPE

        return BRATS_SHAPE
