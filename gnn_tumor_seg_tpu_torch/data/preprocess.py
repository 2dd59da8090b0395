"""Dataset preprocessing: raw BraTS MRI folders -> preprocessed samples
(counterpart of gnn_tumor_seg_tpu/data/preprocess.py).

Capability match for `scripts/preprocess_dataset.py` (DataPreprocessor): discover
MRI folders, standardize images (0.995-quantile normalize + dataset mean/std),
swap labels BraTS->training, build the supervoxel graph (with intensity edge
weights when `weighted`), and write the artifact set per sample;
embarrassingly parallel across samples via a host thread pool with
per-sample exception isolation (`preprocess_dataset.py:133-143`).

Artifacts per sample (reference names + the native binary graph):
  <id>_input.nii.gz  <id>_label.nii.gz  <id>_supervoxels.nii.gz  <id>_crop.npy
  <id>_graph.npz  <id>_meta.json  [optional: <id>_nxgraph.json for reference interop]

prep_impl="device" runs each sample's normalization quantile,
standardization, smoothing and SLIC assignment as one chain on the card
(ops/slic_device.serve_preprocess_device, the serve path's chain); the host
computes the graph features from the raw crop through the equivalent
affine map and writes the standardized volume with the chain's q, bitwise
the host path's. One chain runs at a time under a lock, so the pool's
threads overlap the connectivity, statistics and NIfTI writes of one sample
with the chain of the next.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import threading

import numpy as np

from ..runtime import enable_host_alloc_reuse, resolve_device
from . import nifti, store
from .graph_build import build_graph_sample, sample_from_partition
from .image import (_fast_quantile_per_channel, determine_brain_crop,
                    normalize_img, swap_labels_from_brats)

__all__ = ["DataPreprocessor", "STANDARDIZATION_STATS", "DEFAULT_MODALITY_EXTS"]

# BraTS2021 healthy-tissue stats (per modality means/stds) — recomputed only when
# set to None, exactly like `preprocess_dataset.py:17,57`.
STANDARDIZATION_STATS = (
    [0.4645, 0.6625, 0.4064, 0.3648],
    [0.1593, 0.1703, 0.1216, 0.1627],
)
DEFAULT_MODALITY_EXTS = ["_flair.nii.gz", "_t1.nii.gz", "_t1ce.nii.gz", "_t2.nii.gz"]
N_THREADS = 6


class DataPreprocessor:
    def __init__(self, data_dir: str, output_dir: str,
                 num_nodes: int = 15000, num_neighbors: int | None = 10,
                 boxiness: float = 0.5, mri_prefix: str = "",
                 modality_extensions=None, label_extension: str | None = None,
                 standardization_stats=STANDARDIZATION_STATS,
                 save_json: bool = False, n_threads: int = N_THREADS,
                 slic_fn=None, weighted: bool = False,
                 prep_impl: str = "host", device="cuda"):
        """device: where prep_impl='device' runs its chain, the card unless
        the caller asks for the CPU; the host path never reads it."""
        if prep_impl not in ("host", "device"):
            raise ValueError(f"unknown prep_impl {prep_impl!r}; expected "
                             "'host' or 'device'")
        self.prep_impl = prep_impl
        self.device = resolve_device(device) if prep_impl == "device" else None
        self._device_lock = threading.Lock()
        self.num_nodes = num_nodes
        self.num_neighbors = num_neighbors or None   # 0 -> contiguity mode
        self.boxiness = boxiness
        self.data_dir = os.path.expanduser(data_dir)
        self.output_dir = os.path.expanduser(output_dir)
        self.modality_extensions = modality_extensions or DEFAULT_MODALITY_EXTS
        self.label_extension = label_extension
        self.include_labels = label_extension is not None
        self.save_json = save_json
        self.n_threads = n_threads
        self.slic_fn = slic_fn
        self.weighted = weighted

        # per-sample numpy volumes are ~80-140 MB; keep them in the heap so
        # page faults are paid once per process, not once per sample
        enable_host_alloc_reuse()

        self.all_ids, self.id_to_fp = self._discover(mri_prefix)
        stats = (self.compute_dataset_stats()
                 if standardization_stats is None else standardization_stats)
        self.dataset_mean = np.asarray(stats[0], np.float32)
        self.dataset_std = np.asarray(stats[1], np.float32)

    def _discover(self, prefix: str):
        folders = glob.glob(os.path.join(self.data_dir, "**", f"{prefix}*") + os.sep,
                            recursive=True)
        mapping = {}
        for fp in sorted(folders):
            mri_id = os.path.basename(os.path.normpath(fp))
            if any(
                f.endswith(ext) for f in os.listdir(fp)
                for ext in self.modality_extensions
            ):
                mapping[mri_id] = fp
        if not mapping:
            print("Double check input path.")
        print(f"Found {len(mapping)} MRIs")
        return list(mapping), mapping

    # ------------------------------------------------------------ statistics
    def compute_dataset_stats(self):
        """Median-of-per-brain healthy-tissue mean/std per modality
        (`preprocess_dataset.py:93-115`)."""
        print("Computing dataset mean and SD")
        means, stds = [], []
        for mri_id in self.all_ids:
            img = nifti.read_in_patient_sample(self.id_to_fp[mri_id],
                                               self.modality_extensions)
            lab = nifti.read_in_labels(self.id_to_fp[mri_id], self.label_extension)
            if img.ndim > 3:
                healthy = np.logical_and(img[..., 0] > 0.001, lab == 0)
                flat = normalize_img(img[healthy], is_flat=True)
                means.append(np.mean(flat, axis=0))
                stds.append(np.std(flat, axis=0))
            else:
                means.append(np.mean(img))
                stds.append(np.std(img))
        m, s = np.median(means, axis=0), np.median(stds, axis=0)
        print(f"Mean:{m}, SD: {s} ")
        return m, s

    # ------------------------------------------------------------ per sample
    def get_standardized_image(self, scan_dir: str):
        image = nifti.read_in_patient_sample(scan_dir, self.modality_extensions)
        crop = determine_brain_crop(image)
        cropped = image[crop]
        labels = None
        if self.include_labels:
            raw_labels = nifti.read_in_labels(scan_dir, self.label_extension)
            labels = swap_labels_from_brats(raw_labels[crop])
        # in-place normalize + standardize on the cropped copy: no new
        # full-volume temporaries
        maxes = _fast_quantile_per_channel(cropped, 0.995)
        cropped /= maxes
        cropped -= self.dataset_mean
        cropped /= self.dataset_std
        return cropped, labels, crop, image.shape[:3]

    def get_raw_cropped(self, scan_dir: str):
        """Raw (pre-normalization) cropped volume and labels, for the device
        preprocessing path."""
        image = nifti.read_in_patient_sample(scan_dir, self.modality_extensions)
        crop = determine_brain_crop(image)
        cropped = np.ascontiguousarray(image[crop])
        labels = None
        if self.include_labels:
            raw_labels = nifti.read_in_labels(scan_dir, self.label_extension)
            labels = swap_labels_from_brats(raw_labels[crop])
        return cropped, labels, crop, image.shape[:3]

    def _process_one_device(self, mri_id: str):
        """prep_impl='device': the normalization quantile, standardization,
        smoothing and SLIC assignment as one chain on the card, from one
        upload of the raw crop. The chain holds the lock (one in flight: each
        holds several volumes on the card); the host then computes the graph
        from the raw crop through the positive affine of the chain's q and
        standardizes the artifact in place in the host path's operation
        order ((x / q - mean) / std), so it is bitwise the host path's."""
        from ..ops.slic_device import finalize_labels, serve_preprocess_device

        raw, labels, crop, orig_shape = self.get_raw_cropped(
            self.id_to_fp[mri_id])
        with self._device_lock:
            labels_raw, _, q, step = serve_preprocess_device(
                raw, self.num_nodes, self.boxiness, self.dataset_mean,
                self.dataset_std, sigma=1.0, device=self.device)
        sv = finalize_labels(labels_raw, step)
        a = (1.0 / (q * self.dataset_std)).astype(np.float32)
        b = (-self.dataset_mean / self.dataset_std).astype(np.float32)
        sample = sample_from_partition(raw, labels, sv, self.num_neighbors,
                                       weighted=self.weighted,
                                       feat_affine=(a, b))
        raw /= q
        raw -= self.dataset_mean
        raw /= self.dataset_std
        return raw, labels, crop, orig_shape, sample

    def process_one(self, mri_id: str) -> str:
        if self.prep_impl == "device":
            image, labels, crop, orig_shape, sample = \
                self._process_one_device(mri_id)
        else:
            image, labels, crop, orig_shape = self.get_standardized_image(
                self.id_to_fp[mri_id])
            sample = build_graph_sample(
                image, labels, self.num_nodes, self.boxiness,
                self.num_neighbors, slic_fn=self.slic_fn,
                weighted=self.weighted,
            )
        out = os.path.join(self.output_dir, mri_id)
        os.makedirs(out, exist_ok=True)
        pre = os.path.join(out, mri_id)
        store.save_graph_npz(f"{pre}_graph.npz", sample)
        if self.save_json:
            store.save_networkx_json(f"{pre}_nxgraph.json", sample)
        nifti.save_as_nifti(image, f"{pre}_input.nii.gz")
        if labels is not None:
            nifti.save_as_nifti(labels, f"{pre}_label.nii.gz")
        nifti.save_as_nifti(sample.sv_partition, f"{pre}_supervoxels.nii.gz")
        # np.ix_ tuples are ragged; store as an object array (read back with
        # allow_pickle, same as the reference's crop artifact contract)
        crop_arr = np.empty(len(crop), dtype=object)
        for i, c in enumerate(crop):
            crop_arr[i] = c
        np.save(f"{pre}_crop.npy", crop_arr)
        # original raw shape, so predictions uncrop to the true input size
        # (the reference hardcodes (240,240,155), image_processing.py:23)
        with open(f"{pre}_meta.json", "w") as f:
            json.dump({"orig_shape": list(orig_shape)}, f)
        return mri_id

    def run(self) -> list[str]:
        done = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=self.n_threads) as ex:
            futures = {ex.submit(self.process_one, mri_id): mri_id
                       for mri_id in self.all_ids}
            print("Set up Threads, starting execution")
            for fut in concurrent.futures.as_completed(futures):
                try:
                    mri_id = fut.result()
                except Exception as exc:   # per-sample isolation
                    print(f"Thread generated exception {exc}")
                else:
                    print("Finished " + mri_id)
                    done.append(mri_id)
        return done
