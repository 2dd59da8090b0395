"""BraTS evaluation metrics: region Dice and 95th-percentile Hausdorff distance.

Capability match for the reference's `model/evaluation.py`:
  - class ids after remap: 0 healthy, 1 edema, 2 NET/NCR, 3 ET
    (`model/evaluation.py:18-21`)
  - regions: WT = any tumor; CT/TC = {NET, ET}; ET = ET alone
    (`model/evaluation.py:32-46,64-80`)
  - Dice from TP/FP/FN with the empty-empty case scored 1 (`model/evaluation.py:98-106`)
  - HD95 fallbacks: 0 when the region is absent from both volumes, 300 when absent
    from exactly one (`model/evaluation.py:83-95`)

HD95 here is an original implementation via scipy's Euclidean distance transform:
surface voxels are extracted with a binary erosion (full-connectivity-1 cross
footprint), each volume's surface is measured against the EDT of the other's
surface complement, and the symmetric 95th percentile is returned — numerically the
same definition medpy uses, without its era-locked private-API calls
(SURVEY §2.2.7). Runs host-side: eval is per-brain and EDT is latency-bound, not a
training-hot-path op.

A copy of gnn_tumor_seg_tpu/evaluation.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = [
    "HEALTHY", "EDEMA", "NET", "ET",
    "count_node_labels", "calculate_node_dices", "calculate_brats_metrics",
    "dice_binary", "hd95", "hd95_safe", "compute_accuracy", "print_metrics",
]

HEALTHY = 0
EDEMA = 1
NET = 2
ET = 3

_HD95_MISSING = 300.0  # penalty when region present in exactly one volume


def count_node_labels(preds_or_labels: np.ndarray, n_classes: int = 4) -> np.ndarray:
    """Per-class element counts as a length-n_classes vector."""
    vals, cts = np.unique(preds_or_labels, return_counts=True)
    counts = np.zeros(n_classes)
    for v, c in zip(vals, cts):
        if 0 <= v < n_classes:
            counts[v] = c
    return counts


def dice_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """Dice from binary masks; 1.0 when both are empty."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    tp = np.count_nonzero(pred & gt)
    fp = np.count_nonzero(pred & ~gt)
    fn = np.count_nonzero(~pred & gt)
    if tp + fp + fn == 0:
        return 1.0
    return 2.0 * tp / (2.0 * tp + fp + fn)


def _region_masks(arr: np.ndarray):
    arr = np.asarray(arr)
    return (arr != HEALTHY), np.isin(arr, (NET, ET)), (arr == ET)


def calculate_node_dices(preds: np.ndarray, labels: np.ndarray) -> list[float]:
    """Node-wise WT/CT/ET Dice for one brain (`model/evaluation.py:32-46`)."""
    return [dice_binary(p, g) for p, g in zip(_region_masks(preds), _region_masks(labels))]


def _surface(mask: np.ndarray) -> np.ndarray:
    footprint = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=footprint, iterations=1)
    return mask & ~eroded


def _surface_to_surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from every surface voxel of `a` to the nearest surface voxel of `b`."""
    dt = ndimage.distance_transform_edt(~_surface(b))
    return dt[_surface(a)]


def _union_bbox_crop(a: np.ndarray, b: np.ndarray):
    """Crop both masks to the union bounding box + 1 voxel.

    Exact for surface distances: every surface voxel of either mask lies inside
    the box, so each surface point's nearest counterpart is unchanged. Turns
    240^3 EDTs into tumor-sized ones (~30x faster evaluation)."""
    union = a | b
    slices = ndimage.find_objects(union.astype(np.uint8))[0]
    padded = tuple(
        slice(max(s.start - 1, 0), min(s.stop + 1, dim))
        for s, dim in zip(slices, a.shape)
    )
    return a[padded], b[padded]


def hd95(pred: np.ndarray, gt: np.ndarray) -> float:
    """Symmetric 95th-percentile Hausdorff distance between two binary masks.

    Raises ValueError if either mask is empty (handled by hd95_safe).
    """
    pred = np.atleast_1d(np.asarray(pred, bool))
    gt = np.atleast_1d(np.asarray(gt, bool))
    if not pred.any() or not gt.any():
        raise ValueError("empty mask")
    if pred.ndim == 3:
        pred, gt = _union_bbox_crop(pred, gt)
    d_pg = _surface_to_surface_distances(pred, gt)
    d_gp = _surface_to_surface_distances(gt, pred)
    return float(np.percentile(np.hstack((d_pg, d_gp)), 95))


def hd95_safe(pred: np.ndarray, gt: np.ndarray) -> float:
    """HD95 with the reference's fallback constants (`model/evaluation.py:83-95`)."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    p_any, g_any = bool(pred.any()), bool(gt.any())
    if not p_any and not g_any:
        return 0.0
    if not (p_any and g_any):
        return _HD95_MISSING
    return hd95(pred, gt)


def calculate_brats_metrics(pred_voxels: np.ndarray, true_voxels: np.ndarray) -> list[float]:
    """[WT dice, CT dice, ET dice, WT hd95, CT hd95, ET hd95] for one brain."""
    pred_masks = _region_masks(pred_voxels)
    gt_masks = _region_masks(true_voxels)
    dices = [dice_binary(p, g) for p, g in zip(pred_masks, gt_masks)]
    hds = [hd95_safe(p, g) for p, g in zip(pred_masks, gt_masks)]
    return dices + hds


def compute_accuracy(pred: np.ndarray, gt: np.ndarray, include_healthy: bool = True) -> float:
    """Voxel accuracy, optionally over tumor-labelled GT voxels only
    (`model/evaluation.py:50-59`; useful for achievable segmentation accuracy)."""
    assert pred.shape == gt.shape
    if include_healthy:
        return float(np.mean(pred == gt))
    m = gt != 0
    return float(np.sum((pred == gt) & m) / max(np.sum(m), 1))


def print_metrics(loss, dsc, hd):
    print(f"Loss : {loss}")
    for name, d in zip(("WT", "CT", "AT"), dsc):
        print(f"{name} Dice : {d}")
    for name, h in zip(("WT", "CT", "AT"), hd):
        print(f"{name} HD95 : {h}")
