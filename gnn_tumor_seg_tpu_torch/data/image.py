"""Host-side image processing: crops, normalization, label remapping, projection.

Capability match for `data_processing/image_processing.py`,
`scripts/preprocess_dataset.py:146-169` (label swaps) and
`data_processing/graph_io.py:21-24` (node->voxel projection). These are offline /
per-sample host ops (numpy), not training-hot-path device code.

A copy of gnn_tumor_seg_tpu/data/image.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = [
    "BRATS_SHAPE", "LABEL_MAP",
    "determine_brain_crop", "determine_tumor_crop", "uncrop_to_brats_size",
    "normalize_img", "standardize_img",
    "swap_labels_from_brats", "swap_labels_to_brats",
    "project_nodes_to_img",
]

BRATS_SHAPE = (240, 240, 155)          # image_processing.py:23
# BraTS label ids -> contiguous training ids: ET 4->3, ED 2->1, NCR/NET 1->2
LABEL_MAP = {4: 3, 2: 1, 1: 2}         # preprocess_dataset.py:15


def determine_brain_crop(volume: np.ndarray):
    """Index tuple of the tightest crop dropping all-black planes
    (`image_processing.py:31-41`). Accepts (X,Y,Z) or (X,Y,Z,C); returns np.ix_
    so labels can be cropped with the same indices."""
    if volume.ndim == 4:
        intensity = np.amax(volume, axis=3)
    elif volume.ndim == 3:
        intensity = volume
    else:
        raise ValueError(f"expected 3D or 4D volume, got shape {volume.shape}")
    mask = intensity > 0.01
    return np.ix_(mask.any(axis=(1, 2)), mask.any(axis=(0, 2)), mask.any(axis=(0, 1)))


def determine_tumor_crop(preds: np.ndarray):
    """Bounding crop around predicted tumor, dilated by one voxel
    (`image_processing.py:8-17`); falls back to the whole volume when no tumor is
    predicted."""
    mask = ndimage.binary_dilation(preds != 0)
    if not mask.any():
        print("No GNN predicted tumor, not cropping image")
        mask = ~mask
    return np.ix_(mask.any(axis=(1, 2)), mask.any(axis=(0, 2)), mask.any(axis=(0, 1)))


def uncrop_to_brats_size(crop, voxel_preds: np.ndarray, shape=BRATS_SHAPE) -> np.ndarray:
    """Embed cropped predictions back into a healthy-filled full-size volume
    (`image_processing.py:21-25`)."""
    full = np.zeros(shape, dtype=np.int16)
    full[crop] = voxel_preds
    return full


def _fast_quantile_per_channel(img: np.ndarray, q: float) -> np.ndarray:
    """np.partition-based per-channel quantile (linear interpolation) — O(n)
    instead of np.quantile's full sort (~14s on a full brain volume)."""
    flat = img.reshape(-1, img.shape[-1])
    m = flat.shape[0]
    pos = (m - 1) * q
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    frac = pos - lo
    out = np.empty(img.shape[-1], np.float32)
    for c in range(img.shape[-1]):
        part = np.partition(flat[:, c], [lo, hi])
        out[c] = part[lo] * (1 - frac) + part[hi] * frac
    return out


def normalize_img(img: np.ndarray, is_flat: bool = False) -> np.ndarray:
    """Scale each modality by its 0.995 quantile (`image_processing.py:45-51`)."""
    if img.ndim >= 2:
        maxes = _fast_quantile_per_channel(
            img if is_flat else img.reshape(-1, img.shape[-1]), 0.995
        )
    else:
        maxes = np.quantile(img, 0.995).astype(np.float32)
    return img / maxes


def standardize_img(img: np.ndarray, mean, std) -> np.ndarray:
    return (img - mean) / std


def _check_labels(arr: np.ndarray, allowed) -> None:
    bad = np.setdiff1d(np.unique(arr), allowed)
    if bad.size:
        raise RuntimeError(f"unexpected label(s) {bad.tolist()}")


def swap_labels_from_brats(labels: np.ndarray) -> np.ndarray:
    """BraTS {0,1,2,4} -> training {0,1,2,3} (`preprocess_dataset.py:146-156`)."""
    _check_labels(labels, [0, 1, 2, 4])
    out = np.zeros_like(labels, dtype=np.int16)
    for brats_id, train_id in LABEL_MAP.items():
        out[labels == brats_id] = train_id
    return out


def swap_labels_to_brats(labels: np.ndarray) -> np.ndarray:
    """training {0,1,2,3} -> BraTS {0,1,2,4} (`preprocess_dataset.py:159-169`)."""
    _check_labels(labels, [0, 1, 2, 3])
    out = np.zeros_like(labels, dtype=np.int16)
    for brats_id, train_id in LABEL_MAP.items():
        out[labels == train_id] = brats_id
    return out


def project_nodes_to_img(sv_partition: np.ndarray, node_values: np.ndarray) -> np.ndarray:
    """Assign every voxel its supervoxel's value; background (-1) voxels get 0
    (`data_processing/graph_io.py:21-24`). Works for label vectors [N] and logit
    matrices [N, C] alike (background logits appended by the caller for the
    latter)."""
    node_values = np.asarray(node_values)
    if node_values.ndim == 1:
        table = np.append(node_values, 0)
    else:
        table = np.concatenate([node_values, np.zeros((1, node_values.shape[1]),
                                                      node_values.dtype)])
    return table[sv_partition]
