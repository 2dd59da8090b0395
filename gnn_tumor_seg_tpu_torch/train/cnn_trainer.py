"""Refinement-CNN training and evaluation engine (counterpart of
gnn_tumor_seg_tpu/train/cnn_trainer.py), on one device.

Per sample: the GNN's voxel logits (4 channels) and the input image (4
channels) are concatenated channels-last, cropped to the dilated
predicted-tumor bounding box and fed to the two-layer 3D CNN; the loss is
the class-weighted CE against the cropped labels (`model/cnn_model.py:36-56,
85-88`). Samples whose logit file is missing are skipped
(`cnn_model.py:40-43`).

The JAX trainer's behaviour, step for step:
  - crops are padded with edge replication up to per-axis multiples of 16,
    and at least to the crop floor (DEFAULT_CROP_FLOOR, or
    GTS_CNN_CROP_FLOOR), with the loss and metrics masked to the true crop,
    so both packages convolve the same padded volumes;
  - each epoch visits the ids in np.random.default_rng(seed).shuffle order,
    one generator for the trainer's lifetime, so both packages visit the
    samples in the same order;
  - one step is the CNN forward, weighted CE (labels padded with -1, the
    mask the true crop), backward and AdamW; the learning rate is set once
    per epoch from the epoch counter (train/optim.py);
  - training and evaluation run under precision mode "fast" unless the
    trainer is given "exact" (or GTS_PALLAS_PRECISION says so): "fast"
    convolves in bfloat16 and returns float32 logits, "exact" is float32
    with TF32 off for cuDNN and matmul (ops/precision.py);
  - cuDNN times its algorithms for each new crop shape
    (cudnn.benchmark), as XLA autotunes the JAX package's convolutions;
    the crop floor keeps the shapes few. Under "exact" it chooses among
    deterministic algorithms only (cudnn.deterministic), and the
    replicate padding's backward has no atomics
    (models/refine_cnn._replicate_pad), so an exact run repeats bitwise;
  - the losses stay on the device, and an epoch synchronizes once, when it
    reads them.

The prepared samples (the padded input, labels and mask on the device) are
kept in a byte-bounded LRU (GTS_CNN_PREP_CACHE_MB, 4096 by default, 0 turns
it off), so later epochs skip the NIfTI decode, the crop and the upload.
Three things differ from the JAX trainer's cache, each on purpose: the key
holds the logit root as well as the id, so a trainer given another logit
dataset never serves a stale crop; `evaluate` reads its inputs, and the
true labels of the crop, from the cache, where the JAX trainer decodes the
image, labels and logits again; and the trainer counts its hits
(`prep_cache_hits`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from .. import evaluation, spans
from ..config import HyperParams
from ..convert import CNN_KEYS
from ..data.cache import LRUBytesCache
from ..models.refine_cnn import CnnRefinementNet
from ..ops.precision import precision_scope, training_precision
from ..runtime import resolve_device
from .checkpoint import (cnn_from_leaves, load_checkpoint, load_opt_state,
                         save_checkpoint)
from .losses import weighted_cross_entropy
from .optim import (epoch_lr, load_opt_state_leaves, make_optimizer,
                    opt_state_leaves, set_lr)

__all__ = ["CNNTrainer", "PreparedSample", "combine_logits_and_image",
           "pad_to_bucket", "default_crop_floor", "DEFAULT_CROP_FLOOR"]

_CROP_BUCKET = 16
DEFAULT_CROP_FLOOR = (128, 128, 128)
# conv weights: the port's OIDHW against the JAX package's DHWIO
_OIDHW_TO_DHWIO = (2, 3, 4, 1, 0)
_DHWIO_TO_OIDHW = (4, 3, 0, 1, 2)


def combine_logits_and_image(gnn_logits: np.ndarray, img: np.ndarray,
                             tumor_crop) -> np.ndarray:
    """Concat [image(4ch), logits(4ch)] channels-last and crop -> [dx,dy,dz,8]
    (`model/cnn_model.py:85-88`, channels-last instead of NCDHW)."""
    combined = np.concatenate([img, gnn_logits], axis=-1)
    return combined[tumor_crop]


def pad_to_bucket(vol: np.ndarray, bucket: int = _CROP_BUCKET,
                  floor: tuple[int, int, int] | None = None):
    """Edge-replicate-pad the leading 3 spatial dims up to multiples of
    `bucket`, and at least to `floor` when given. Returns
    (padded, valid_mask[spatial]).

    A dataset-stable floor puts every typical tumor crop on one shape, so
    cuDNN sees one convolution shape (and the JAX package one compiled
    step); oversized crops fall back to the buckets."""
    spatial = vol.shape[:3]
    target = tuple(-(-s // bucket) * bucket for s in spatial)
    if floor is not None:
        target = tuple(max(t, f) for t, f in zip(target, floor))
    pads = [(0, t - s) for s, t in zip(spatial, target)]
    if vol.ndim == 4:
        pads.append((0, 0))
    padded = np.pad(vol, pads, mode="edge")
    mask = np.zeros(target, np.float32)
    mask[: spatial[0], : spatial[1], : spatial[2]] = 1.0
    return padded, mask


def default_crop_floor() -> tuple[int, int, int] | None:
    """CNN crop floor: DEFAULT_CROP_FLOOR unless overridden via
    GTS_CNN_CROP_FLOOR ('X,Y,Z' or 'none'); the variable is shared with the
    JAX package so one setting gives both the same crops."""
    env = os.environ.get("GTS_CNN_CROP_FLOOR")
    if env:
        if env.strip().lower() in ("none", "0"):
            return None
        return tuple(int(v) for v in env.split(","))
    return DEFAULT_CROP_FLOOR


@dataclasses.dataclass
class PreparedSample:
    """One sample ready for the CNN, on the trainer's device."""
    x: torch.Tensor          # [1, X, Y, Z, 8] float32, edge-padded crop
    labels: torch.Tensor     # [1, X, Y, Z] int32, -1 outside the true crop
    mask: torch.Tensor       # [1, X, Y, Z] float32, 1 inside the true crop
    crop: tuple              # np.ix_ indices of the crop in the image

    @property
    def crop_shape(self) -> tuple[int, int, int]:
        return tuple(int(a.size) for a in self.crop)


def _permute_weight_moments(leaves: list[np.ndarray], perm) -> list[np.ndarray]:
    """Optimizer leaves (train/optim.py: scalars, then the first and second
    moments in CNN_KEYS order) with the conv weights' moments permuted
    between the port's OIDHW and the JAX package's DHWIO."""
    out = list(leaves)
    n = len(CNN_KEYS)
    base = len(out) - 2 * n
    for i, (_, key) in enumerate(CNN_KEYS):
        if key == "w":
            for j in (base + i, base + n + i):
                out[j] = np.ascontiguousarray(np.transpose(out[j], perm))
    return out


class CNNTrainer:
    def __init__(self, hp: HyperParams, image_dataset=None, logit_dataset=None,
                 seed: int = 0, crop_floor="default",
                 precision: str | None = None,
                 device: str | torch.device = "cuda"):
        """crop_floor: minimum padded crop shape ("default":
        default_crop_floor(); None: 16-buckets only). Training and
        prediction (cli/common.py) pad alike."""
        self.device = resolve_device(device)
        self.crop_floor = (default_crop_floor() if crop_floor == "default"
                           else crop_floor)
        self.precision = training_precision(precision)
        self.hp = hp
        self.net = CnnRefinementNet(hp.in_feats, hp.out_classes, hp.layer_sizes,
                                    torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.optimizer = make_optimizer(self.net.jax_parameters(), hp)
        self.epoch = 0
        self.class_weights = torch.tensor(hp.class_weights, dtype=torch.float32,
                                          device=self.device)
        self.image_dataset = image_dataset
        self.logit_dataset = logit_dataset
        self.rng = np.random.default_rng(seed)
        mb = int(os.environ.get("GTS_CNN_PREP_CACHE_MB", "4096"))
        self._prep_cache = LRUBytesCache(mb << 20) if mb > 0 else None
        self.prep_cache_hits = 0
        self.last_epoch_stats: dict = {}
        self.last_eval_stats: dict = {}

    @contextlib.contextmanager
    def compute_scope(self):
        """The trainer's precision mode and cuDNN settings (module doc),
        restored on exit."""
        flags = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.deterministic = self.precision == "exact"
        try:
            with precision_scope(self.precision):
                yield
        finally:
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = flags

    # ------------------------------------------------------------------ data
    def _prepare(self, mri_id: str) -> PreparedSample | None:
        """The sample's padded input, labels and mask on the device, or None
        when its logit file is missing (then nothing else is read)."""
        try:
            gnn_logits, crop = self.logit_dataset.get_one(mri_id)
        except FileNotFoundError:
            return None
        img = self.image_dataset.get_image(mri_id)
        x = combine_logits_and_image(gnn_logits, img, crop)
        x, mask = pad_to_bucket(x, floor=self.crop_floor)
        lab = self.image_dataset.get_voxel_labels(mri_id)[crop]
        lab_p = np.full(mask.shape, -1, np.int32)
        lab_p[: lab.shape[0], : lab.shape[1], : lab.shape[2]] = lab
        dev = self.device
        return PreparedSample(
            x=torch.from_numpy(np.ascontiguousarray(x, np.float32))[None].to(dev),
            labels=torch.from_numpy(lab_p)[None].to(dev),
            mask=torch.from_numpy(mask)[None].to(dev),
            crop=crop)

    def _load_and_prepare(self, mri_id: str) -> PreparedSample | None:
        if self._prep_cache is None:
            return self._prepare(mri_id)
        key = (self.logit_dataset.root, mri_id)
        prep = self._prep_cache.get(key)
        if prep is not None:
            self.prep_cache_hits += 1
            return prep
        prep = self._prepare(mri_id)
        if prep is not None:
            self._prep_cache.put(key, prep)
        return prep

    # ------------------------------------------------------------------ step
    def _step(self, prep: PreparedSample) -> torch.Tensor:
        logits = self.net(prep.x)
        loss = weighted_cross_entropy(logits, prep.labels, self.class_weights,
                                      prep.mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # ------------------------------------------------------------------ epochs
    def run_epoch(self) -> float:
        """One shuffled batch-size-1 pass (`model/cnn_model.py:36-56`);
        returns the mean sample loss. The first epoch decodes, crops and
        uploads each sample; later ones take it from the prep cache."""
        if self.image_dataset is None or self.logit_dataset is None:
            raise RuntimeError("trainer constructed without datasets")
        ids = list(self.image_dataset.ids)
        self.rng.shuffle(ids)
        set_lr(self.optimizer, epoch_lr(self.hp.lr, self.hp.lr_decay,
                                        self.epoch))
        hits = self.prep_cache_hits
        losses = []
        t0 = time.perf_counter()
        with self.compute_scope():
            for mri_id in ids:
                prep = self._load_and_prepare(mri_id)
                if prep is None:
                    continue
                with spans.span("cnn_train_step"):
                    losses.append(self._step(prep))
        # the epoch's one host synchronization
        values = (torch.stack(losses).cpu().numpy() if losses
                  else np.zeros(0, np.float32))
        self.last_epoch_stats = {
            "seconds": time.perf_counter() - t0,
            "steps": len(losses),
            "prep_cache_hits": self.prep_cache_hits - hits,
            "precision": self.precision,
        }
        self.epoch += 1
        return float(np.mean(values))

    # ------------------------------------------------------------------ eval
    def evaluate(self, ids=None) -> np.ndarray:
        """Per-sample [loss, WT/CT/ET dice, WT/CT/ET hd95] averaged
        (`model/cnn_model.py:58-78`; metrics over the cropped region). Inputs
        and the crop's true labels come from the prep cache."""
        ids = list(ids if ids is not None else self.image_dataset.ids)
        metrics = np.zeros((len(ids), 7))
        row = 0
        hits = self.prep_cache_hits
        t0 = time.perf_counter()
        with self.compute_scope(), torch.inference_mode():
            for mri_id in ids:
                prep = self._load_and_prepare(mri_id)
                if prep is None:
                    continue
                logits = self.net(prep.x)
                loss = weighted_cross_entropy(logits, prep.labels,
                                              self.class_weights, prep.mask)
                nx, ny, nz = prep.crop_shape
                preds = logits[0, :nx, :ny, :nz].argmax(-1).to(torch.int16)
                true = prep.labels[0, :nx, :ny, :nz].to(torch.int16)
                metrics[row][0] = float(loss)
                metrics[row][1:] = evaluation.calculate_brats_metrics(
                    preds.cpu().numpy(), true.cpu().numpy())
                row += 1
        self.last_eval_stats = {
            "brains": row,
            "prep_cache_hits": self.prep_cache_hits - hits,
            "seconds": time.perf_counter() - t0,
        }
        return np.mean(metrics[:row], axis=0) if row else np.zeros(7)

    @torch.inference_mode()
    def predict_crop(self, x) -> np.ndarray:
        """Float32 logits for one prepared [1,dx,dy,dz,8] input."""
        with self.compute_scope():
            return self.net(torch.as_tensor(x).to(self.device)).cpu().numpy()

    # ------------------------------------------------------------------ io
    def save_weights(self, folder: str, name: str,
                     include_opt_state: bool = True) -> None:
        """Checkpoint `<folder><name>.ckpt` in the JAX package's format, with
        (by default) the optimizer state and epoch counter."""
        opt = None
        if include_opt_state:
            opt = _permute_weight_moments(opt_state_leaves(self.optimizer),
                                          _OIDHW_TO_DHWIO)
        save_checkpoint(f"{folder}{name}.ckpt", self.net, "CNN", self.hp,
                        opt_state=opt, extra={"epoch": self.epoch})

    def load_params(self, params: dict) -> None:
        """Set the parameters from the JAX CNN's parameter dict
        ({"conv0": {"w", "b"}, "conv1": {...}}, DHWIO weights)."""
        self._copy_params([params[a][b] for a, b in CNN_KEYS])

    def _copy_params(self, leaves: list[np.ndarray]) -> None:
        src = cnn_from_leaves(leaves).jax_parameters()
        with torch.no_grad():
            for p, q in zip(self.net.jax_parameters(), src):
                if tuple(q.shape) != tuple(p.shape):
                    raise ValueError(f"CNN parameter {tuple(q.shape)} does not "
                                     f"match the trainer's {tuple(p.shape)}")
                p.copy_(q)

    def restore(self, path: str) -> None:
        """Resume the training state (parameters, optimizer, epoch) from a
        CNN checkpoint of either package; one without optimizer state leaves
        the optimizer as it is."""
        leaves, model_type, _, manifest = load_checkpoint(path)
        if model_type != "CNN":
            raise ValueError(f"expected a CNN checkpoint, got {model_type}")
        self._copy_params(leaves)
        opt = load_opt_state(path)
        if opt is not None:
            load_opt_state_leaves(self.optimizer,
                                  _permute_weight_moments(opt, _DHWIO_TO_OIDHW))
        epoch = manifest.get("extra", {}).get("epoch")
        if epoch is not None:
            self.epoch = int(epoch)
