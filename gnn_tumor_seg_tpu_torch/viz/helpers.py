"""Visualization helpers: colormaps and prediction/GT RGB overlays
(counterpart of gnn_tumor_seg_tpu/viz/helpers.py, reading NIfTI through the
port's own data/nifti.py).

Capability match for `visualization/viz_helpers.py`: fixed class colors (healthy
green/transparent, edema red, NET blue, ET yellow), random supervoxel colormap,
FLAIR/T1CE overlay assembly with the standard [30:220, 30:220] zoom.
`label_lut`, `overlay_labels` and `load_plotting_data` are numpy only;
matplotlib is imported inside the two colormap functions, so importing this
module does not need it.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import nifti

__all__ = ["label_lut", "cluster_cmap", "label_cmap", "overlay_labels",
           "load_plotting_data", "ZOOM"]

ZOOM = (slice(30, 220), slice(30, 220))  # viz_helpers.py:85-88

# class colors: healthy, then (continuous ids 1,2,3) edema red / NET blue / ET yellow
_LUT_CONTINUOUS = np.array([
    [50, 168, 82],    # healthy - green
    [219, 13, 41],    # edema - red
    [13, 51, 219],    # NET - blue
    [219, 185, 13],   # ET - yellow
]) / 255.0
# BraTS id space 0,1,2,(3 unused),4
_LUT_BRATS = np.array([
    [50, 168, 82],
    [13, 51, 219],
    [219, 13, 41],
    [0, 0, 0],
    [219, 185, 13],
]) / 255.0


def label_lut(continuous_labels: bool = False) -> np.ndarray:
    return _LUT_CONTINUOUS if continuous_labels else _LUT_BRATS


def label_cmap(continuous_labels: bool = False):
    from matplotlib.colors import LinearSegmentedColormap

    lut = label_lut(continuous_labels)
    print("Healthy: Green (or transparent), Edema:Red, NET:Blue, ET: Yellow")
    return LinearSegmentedColormap.from_list("label_map", lut, N=len(lut)), lut


def cluster_cmap(sv_partition: np.ndarray, seed: int | None = None):
    """Random color per supervoxel, black background (viz_helpers.py:11-16)."""
    from matplotlib.colors import LinearSegmentedColormap

    n = len(np.unique(sv_partition)) - 1
    rng = np.random.default_rng(seed)
    lut = np.insert(rng.random((n, 3)), 0, (0, 0, 0), axis=0)
    return LinearSegmentedColormap.from_list("cluster_map", lut, N=n)


def overlay_labels(base_gray: np.ndarray, labels: np.ndarray,
                   lut: np.ndarray) -> np.ndarray:
    """Grayscale volume -> RGB with class colors painted over labelled voxels."""
    rgb = np.stack([base_gray] * 3, -1)
    for cls in range(1, len(lut)):
        rgb[labels == cls] = lut[cls]
    return rgb


def load_plotting_data(data_folder: str, seg_folder: str, mri_id: str,
                       mod1_ext: str = "_flair.nii.gz",
                       mod2_ext: str = "_t1ce.nii.gz",
                       read_labels: bool = True, zoom=ZOOM):
    """-> (mod1, mod2, overlaid_preds, overlaid_gt), zoomed
    (viz_helpers.py:62-92). Predictions are read from <seg_folder>/<id>.nii.gz
    in BraTS label space."""
    lut = label_lut(continuous_labels=False)
    case_dir = os.path.join(data_folder, mri_id)

    def _find(ext):
        # BraTS convention is <mri_id><ext>, but accept any file with the
        # modality extension so non-standard naming still plots
        preferred = os.path.join(case_dir, mri_id + ext)
        if os.path.exists(preferred):
            return preferred
        matches = sorted(f for f in os.listdir(case_dir) if f.endswith(ext))
        if not matches:
            raise FileNotFoundError(f"no *{ext} in {case_dir}")
        return os.path.join(case_dir, matches[0])

    mod1 = nifti.read_nifti(_find(mod1_ext), np.float32)
    mod1 = mod1 / np.max(mod1)
    mod2 = nifti.read_nifti(_find(mod2_ext), np.float32)
    mod2 = mod2 / np.max(mod2)
    preds = nifti.read_nifti(os.path.join(seg_folder, f"{mri_id}.nii.gz"), np.int16)
    overlaid_preds = overlay_labels(mod1, preds, lut)
    overlaid_gt = np.zeros_like(overlaid_preds)
    if read_labels:
        labels = nifti.read_nifti(_find("_seg.nii.gz"), np.int16)
        overlaid_gt = overlay_labels(mod1, labels, lut)
    # the standard zoom targets 240x240 BraTS planes; skip it for smaller volumes
    if zoom is not None and all(
        s.stop <= dim for s, dim in zip(zoom, mod1.shape)
    ):
        z = (*zoom, ...)
        return mod1[z[:2]], mod2[z[:2]], overlaid_preds[z], overlaid_gt[z]
    return mod1, mod2, overlaid_preds, overlaid_gt
