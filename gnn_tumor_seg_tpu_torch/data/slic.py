"""SLIC supervoxel segmentation from scratch (skimage replacement).

The reference delegates to skimage's Cython SLIC (`mri2graph/graphgen.py:2,243`)
with sigma=1 smoothing, compactness="boxiness", ~15000 segments, no LAB
conversion. This module implements SLIC (Achanta et al., localized k-means over
color+space) in a *blockwise 27-candidate* formulation:

  - cluster centers initialize on a regular (gx, gy, gz) grid;
  - every voxel only ever competes among the centers of its own grid cell and the
    26 surrounding cells (the classic 2S-window restriction, made static);
  - assignment + center update iterate a fixed number of rounds.

This formulation is chosen because it is *identical* in numpy (here, the host
canonical implementation), in the C++ kernels of native/gts_native.cc and in
the device version (ops/slic_device.py; the JAX package's is
gnn_tumor_seg_tpu/ops/slic_tpu.py) — fixed candidate count, fixed shapes,
masked reductions — so parity between them is directly testable, unlike a
data-dependent priority queue.

A copy of gnn_tumor_seg_tpu/data/slic.py: the port imports nothing of the JAX
package, and its partitions must equal the JAX package's.

Distance convention follows skimage: D^2 = (dc/compactness)^2 + (ds/step)^2, so
higher compactness => boxier supervoxels, matching the reference's CLI semantics
(`scripts/preprocess_dataset.py:179`).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["slic_supervoxels"]


def _init_grid(shape, n_segments):
    """Choose grid dims (gx, gy, gz) with gx*gy*gz ~= n_segments, cells ~cubic."""
    X, Y, Z = shape
    step = (X * Y * Z / max(n_segments, 1)) ** (1.0 / 3.0)
    dims = tuple(max(1, int(round(s / step))) for s in (X, Y, Z))
    return dims, step


def _cell_of(coords, extent, g):
    """Voxel coordinate -> owning grid cell index along one axis."""
    return np.minimum((coords * g) // extent, g - 1).astype(np.int32)


def slic_supervoxels(
    image: np.ndarray,
    n_segments: int = 5000,
    compactness: float = 0.5,
    sigma: float = 1.0,
    max_iter: int = 10,
    enforce_connectivity: bool = True,
    min_size_factor: float = 0.25,
    use_native: bool | str = "auto",
) -> np.ndarray:
    """Partition a 3D (X,Y,Z) or 4D (X,Y,Z,C) volume into supervoxels.

    Returns int32 labels of shape (X,Y,Z), contiguous from 0. Drop-in capability
    for skimage.slic(convert2lab=False) as used at `mri2graph/graphgen.py:243`.

    use_native: route assignment/update (and connectivity) through the C++
    kernels in native/gts_native.cc when the library is available ("auto");
    the numpy path is the algorithmic canonical (same blockwise formulation;
    partition-identical, tested).
    """
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3:
        image = image[..., None]
    X, Y, Z, C = image.shape
    if sigma > 0:
        image = np.stack(
            [ndimage.gaussian_filter(image[..., c], sigma) for c in range(C)], -1
        )
    (gx, gy, gz), step = _init_grid((X, Y, Z), n_segments)
    n_centers = gx * gy * gz

    if use_native in ("auto", True):
        from . import native

        if native.available():
            labels = native.slic3d_native(image, gx, gy, gz, compactness, step,
                                          max_iter)
            if enforce_connectivity:
                labels = native.enforce_connectivity_native(labels)
            return _relabel_contiguous(labels)
        if use_native is True:
            raise RuntimeError("native SLIC requested but libgts_native is unavailable")

    xs = np.arange(X, dtype=np.float32)
    ys = np.arange(Y, dtype=np.float32)
    zs = np.arange(Z, dtype=np.float32)
    cx = _cell_of(np.arange(X), X, gx)
    cy = _cell_of(np.arange(Y), Y, gy)
    cz = _cell_of(np.arange(Z), Z, gz)
    # per-voxel owning cell id [X, Y, Z]
    cell = (cx[:, None, None] * gy + cy[None, :, None]) * gz + cz[None, None, :]

    vox_pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)  # [X,Y,Z,3]
    flat_img = image.reshape(-1, C)
    flat_pos = vox_pos.reshape(-1, 3)
    flat_cell = cell.reshape(-1)

    # initialize centers as the mean color/position of each grid cell
    counts = np.bincount(flat_cell, minlength=n_centers).astype(np.float32)
    counts_safe = np.maximum(counts, 1.0)
    ctr_color = np.stack(
        [np.bincount(flat_cell, flat_img[:, c], n_centers) for c in range(C)], -1
    ) / counts_safe[:, None]
    ctr_pos = np.stack(
        [np.bincount(flat_cell, flat_pos[:, d], n_centers) for d in range(3)], -1
    ) / counts_safe[:, None]

    # candidate table: for each cell, its 27 neighbor cells (clipped; mask invalid)
    ids = np.arange(n_centers).reshape(gx, gy, gz)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    cand = np.empty((27, n_centers), np.int32)
    cand_valid = np.empty((27, n_centers), bool)
    for k, (dx, dy, dz) in enumerate(offsets):
        ix = np.arange(gx) + dx
        iy = np.arange(gy) + dy
        iz = np.arange(gz) + dz
        vx = (ix >= 0) & (ix < gx)
        vy = (iy >= 0) & (iy < gy)
        vz = (iz >= 0) & (iz < gz)
        nb = ids[np.clip(ix, 0, gx - 1)][:, np.clip(iy, 0, gy - 1)][:, :, np.clip(iz, 0, gz - 1)]
        cand[k] = nb.reshape(-1)
        cand_valid[k] = (vx[:, None, None] & vy[None, :, None] & vz[None, None, :]).reshape(-1)

    inv_m2 = 1.0 / max(compactness, 1e-8) ** 2
    inv_s2 = 1.0 / step ** 2

    assign = flat_cell.copy()
    for _ in range(max_iter):
        best_d = np.full(flat_cell.shape, np.inf, np.float32)
        best_c = assign
        for k in range(27):
            ci = cand[k][flat_cell]                    # [V] candidate center per voxel
            valid = cand_valid[k][flat_cell]
            dc = flat_img - ctr_color[ci]
            ds = flat_pos - ctr_pos[ci]
            d = (dc * dc).sum(-1) * inv_m2 + (ds * ds).sum(-1) * inv_s2
            d = np.where(valid, d, np.inf)
            take = d < best_d
            best_d = np.where(take, d, best_d)
            best_c = np.where(take, ci, best_c)
        assign = best_c
        # update centers
        counts = np.bincount(assign, minlength=n_centers).astype(np.float32)
        counts_safe = np.maximum(counts, 1.0)
        ctr_color = np.stack(
            [np.bincount(assign, flat_img[:, c], n_centers) for c in range(C)], -1
        ) / counts_safe[:, None]
        ctr_pos = np.stack(
            [np.bincount(assign, flat_pos[:, d], n_centers) for d in range(3)], -1
        ) / counts_safe[:, None]

    labels = assign.reshape(X, Y, Z)
    if enforce_connectivity:
        labels = _enforce_connectivity(labels, min_size=int((step ** 3) * min_size_factor))
    return _relabel_contiguous(labels)


def _relabel_contiguous(labels: np.ndarray) -> np.ndarray:
    # O(n) bincount remap (np.unique's sort costs ~9s on a 240^3 volume)
    counts = np.bincount(labels.reshape(-1))
    remap = np.cumsum(counts > 0).astype(np.int32) - 1
    return remap[labels]


def _enforce_connectivity(labels: np.ndarray, min_size: int,
                          max_passes: int = 5) -> np.ndarray:
    """Keep each supervoxel's largest connected component; absorb fragments into
    an adjacent neighbor (skimage-style cleanup). Iterates to a fixpoint because
    absorbing a fragment into a neighbor can itself create a new fragment."""
    out = labels.copy()
    structure = ndimage.generate_binary_structure(3, 1)
    for _ in range(max_passes):
        changed = False
        # find_objects treats values <= 0 as background, so shift ids by 1
        objects = ndimage.find_objects(out + 1)
        for lab, sl in enumerate(objects):
            if sl is None:
                continue
            # pad the bbox by 1 so neighbor labels are visible for reassignment
            sl = tuple(
                slice(max(s.start - 1, 0), min(s.stop + 1, dim))
                for s, dim in zip(sl, out.shape)
            )
            box = out[sl]
            mask = box == lab
            comp, n = ndimage.label(mask, structure=structure)
            if n <= 1:
                continue
            sizes = ndimage.sum_labels(np.ones_like(comp), comp, np.arange(1, n + 1))
            keep = int(np.argmax(sizes)) + 1
            for c in range(1, n + 1):
                if c == keep:
                    continue
                frag = comp == c
                # absorb into the modal neighboring label around the fragment
                ring = ndimage.binary_dilation(frag, structure=structure) & ~frag
                ring_labels = box[ring]
                ring_labels = ring_labels[ring_labels != lab]
                if ring_labels.size:
                    vals, cts = np.unique(ring_labels, return_counts=True)
                    box[frag] = vals[np.argmax(cts)]
                    changed = True
            out[sl] = box
        if not changed:
            break
    return out
