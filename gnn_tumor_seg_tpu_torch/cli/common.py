"""Shared CLI helpers: checkpoint-driven model loading and the joint
GNN -> CNN per-sample prediction chain (counterpart of
gnn_tumor_seg_tpu/cli/common.py).

Two variants with the same output: `predict_one_sample_device` (the default)
keeps the GNN logits on the card and gathers the CNN's input crop there;
`predict_one_sample` materializes the voxel logits on the host, as the
reference does. The CNN crop is padded to the JAX package's bucket and floor
(`_CROP_BUCKET`, `default_crop_floor`): edge-replicated rows are not the same
as the conv's replicate padding near the crop face, so parity with the JAX
package needs the same padding. The JAX package's fixed serve pad shape
(`BRATS_RAW_SHAPE`) exists only to avoid XLA recompiles and pads with
background, so the port does not pad.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from ..config import DEFAULT_BACKGROUND_NODE_LOGITS
from ..ops.precision import compute_dtype
from ..runtime import resolve_device
from ..train.checkpoint import cnn_from_leaves, gnn_from_leaves, load_checkpoint

__all__ = [
    "load_gnn_from_checkpoint", "load_cnn_from_checkpoint",
    "node_logits_to_voxel_logits", "predict_one_sample",
    "predict_one_sample_device", "resolve_slic_fn",
    "combine_logits_and_image", "pad_to_bucket", "default_crop_floor",
]

# Copies of gnn_tumor_seg_tpu/train/cnn_trainer.py's crop padding (that
# module imports JAX): per-axis crop buckets of 16, floored at 128^3.
_CROP_BUCKET = 16
DEFAULT_CROP_FLOOR = (128, 128, 128)


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
    (padded, valid_mask[spatial])."""
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


def resolve_slic_fn(impl: str):
    """Map a --slic_impl choice to a slic_fn for build_graph_sample. The
    device SLIC ('tpu', gnn_tumor_seg_tpu/ops/slic_tpu.py) is not ported."""
    if impl == "auto":
        return None
    if impl in ("native", "numpy"):
        from ..data.slic import slic_supervoxels

        return partial(slic_supervoxels, use_native=(impl == "native"))
    raise ValueError(f"unknown or unported slic impl {impl!r}")


def load_gnn_from_checkpoint(weight_file: str, device="cuda"):
    """Rebuild the graph net from its embedded config. Returns
    (model, hp, forward); forward(graph) -> float32 node logits [B, N, C] on
    the model's device."""
    dev = resolve_device(device)
    leaves, model_type, hp, _ = load_checkpoint(weight_file)
    model = gnn_from_leaves(leaves, model_type, hp, device=dev).eval()

    @torch.inference_mode()
    def forward(graph):
        return model(graph.to(dev))

    return model, hp, forward


def load_cnn_from_checkpoint(weight_file: str, device="cuda"):
    """Returns (net, hp, forward); forward(x [B,D,H,W,C]) -> float32 logits
    on the net's device."""
    dev = resolve_device(device)
    leaves, model_type, hp, _ = load_checkpoint(weight_file)
    if model_type != "CNN":
        raise ValueError(f"expected CNN checkpoint, got {model_type}")
    net = cnn_from_leaves(leaves, device=dev).eval()

    @torch.inference_mode()
    def forward(x):
        return net(x.to(dev))

    return net, hp, forward


def _background_row(n_classes: int) -> np.ndarray:
    """The placeholder logits of background voxels; the reference's fixed
    4-wide [[1,-1,-1,-1]] (`hyperparam_helpers.py:25`) widened to the class
    count."""
    if n_classes == len(DEFAULT_BACKGROUND_NODE_LOGITS[0]):
        return np.asarray(DEFAULT_BACKGROUND_NODE_LOGITS, np.float32)
    return np.asarray([[1.0] + [-1.0] * (n_classes - 1)], np.float32)


def node_logits_to_voxel_logits(node_logits: np.ndarray,
                                sv_partition: np.ndarray) -> np.ndarray:
    """Append the background placeholder row and gather per voxel
    (`scripts/generate_gnn_predictions.py:55-62`)."""
    bg = _background_row(node_logits.shape[-1]).astype(node_logits.dtype)
    table = np.concatenate([node_logits, bg])
    return table[sv_partition]


def _dilated_axis_masks(m: torch.Tensor):
    """One binary dilation of boolean volume m with the 3-D cross (scipy's
    default structure, zero-extended at the edges), reduced to per-axis
    any-masks."""
    d = m.clone()
    d[1:] |= m[:-1]
    d[:-1] |= m[1:]
    d[:, 1:] |= m[:, :-1]
    d[:, :-1] |= m[:, 1:]
    d[:, :, 1:] |= m[:, :, :-1]
    d[:, :, :-1] |= m[:, :, 1:]
    return d.any(2).any(1), d.any(2).any(0), d.any(1).any(0)


def _axis_indices(ax_mask: np.ndarray, bucket: int, floor: int = 0):
    """Tumor-crop row indices along one axis (np.ix_ semantics), padded by
    repeating the last row (edge replicate) up to the bucket multiple and at
    least to `floor`. All-False falls back to the full axis (the reference's
    behaviour when no tumor is predicted)."""
    idxs = np.where(ax_mask)[0]
    if idxs.size == 0:
        idxs = np.arange(ax_mask.shape[0])
    n = int(idxs.size)
    padded_len = max(-(-n // bucket) * bucket, floor)
    padded = np.concatenate(
        [idxs, np.full(padded_len - n, idxs[-1], idxs.dtype)])
    return padded.astype(np.int64), n, idxs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def predict_one_sample_device(gnn_forward, cnn_forward, graph,
                              img: np.ndarray, sv_partition: np.ndarray,
                              stage_times: dict | None = None) -> np.ndarray:
    """Joint chain with the GNN logits kept on the card (same output as
    `predict_one_sample`). The host uploads the int16 supervoxel partition
    and the 4-channel image (bf16 under "fast"); voxel gather, argmax,
    cross dilation and the per-axis tumor masks run on the card; the host
    pulls three small axis masks to choose the crop, and three index_selects
    on the card build the CNN input. Returns int16 labels in training id
    space."""
    rec = time.perf_counter
    t0 = rec()
    node_logits = gnn_forward(graph)[0].float()              # [Nmax, C]
    dev = node_logits.device
    n_max = node_logits.shape[0]
    bg = torch.from_numpy(_background_row(node_logits.shape[-1])).to(dev)
    table = torch.cat([node_logits, bg], 0)                  # [Nmax+1, C]
    sv = torch.from_numpy(sv_partition.astype(np.int16, copy=False)).to(dev)
    idx = torch.where(sv < 0, n_max, sv.long())
    vox = table[idx]                                         # [X, Y, Z, C]
    mx, my, mz = (m.cpu().numpy() for m in
                  _dilated_axis_masks(vox.argmax(-1) != 0))
    t1 = rec()
    fl = default_crop_floor() or (0, 0, 0)
    ix, nx, rx = _axis_indices(mx, _CROP_BUCKET, floor=fl[0])
    iy, ny, ry = _axis_indices(my, _CROP_BUCKET, floor=fl[1])
    iz, nz, rz = _axis_indices(mz, _CROP_BUCKET, floor=fl[2])
    cd = compute_dtype()
    # under "fast" the image goes up as bf16, as the JAX package ships it
    img_up = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    img_up = img_up.to(cd).to(dev).float()
    x = torch.cat([img_up, vox], -1)
    x = x.index_select(0, torch.from_numpy(ix).to(dev))
    x = x.index_select(1, torch.from_numpy(iy).to(dev))
    x = x.index_select(2, torch.from_numpy(iz).to(dev)).to(cd)
    if stage_times is not None:
        _sync(dev)
    t2 = rec()
    refined = cnn_forward(x[None])[0]
    preds = refined.argmax(-1).to(torch.int16).cpu().numpy()
    t3 = rec()
    preds = preds[:nx, :ny, :nz]
    out = np.zeros_like(sv_partition, dtype=np.int16)
    out[np.ix_(rx, ry, rz)] = preds
    if stage_times is not None:
        stage_times["gnn_forward"] = t1 - t0
        stage_times["crop_and_prep"] = t2 - t1
        stage_times["cnn_forward"] = t3 - t2
        stage_times["cnn_crop_shape"] = [nx, ny, nz]
    return out


def predict_one_sample(gnn_forward, cnn_forward, graph, img: np.ndarray,
                       sv_partition: np.ndarray,
                       stage_times: dict | None = None) -> np.ndarray:
    """Joint GNN -> CNN chain for one brain, host-materialized
    (`scripts/generate_joint_predictions.py:59-73`): GNN node logits -> voxel
    logits -> tumor crop -> CNN refinement -> argmax embedded into the full
    (cropped-brain) volume. Returns int16 labels in training id space."""
    from ..data.image import determine_tumor_crop

    rec = time.perf_counter
    t0 = rec()
    node_logits = gnn_forward(graph)[0].float().cpu().numpy()
    node_logits = node_logits[: int(graph.n_nodes[0])]
    t1 = rec()
    voxel_logits = node_logits_to_voxel_logits(node_logits, sv_partition)
    tumor_crop = determine_tumor_crop(voxel_logits.argmax(-1))
    x = combine_logits_and_image(voxel_logits, img, tumor_crop)
    true_shape = x.shape[:3]
    x, _ = pad_to_bucket(x, floor=default_crop_floor())
    # under "fast" the CNN computes in bf16 anyway: cast before the upload
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(compute_dtype())
    t2 = rec()
    refined = cnn_forward(x[None])[0]
    preds = refined.argmax(-1).to(torch.int16).cpu().numpy()
    t3 = rec()
    preds = preds[: true_shape[0], : true_shape[1], : true_shape[2]]
    out = np.zeros_like(sv_partition, dtype=np.int16)
    out[tumor_crop] = preds
    if stage_times is not None:
        stage_times["gnn_forward"] = t1 - t0
        stage_times["crop_and_prep"] = t2 - t1
        stage_times["cnn_forward"] = t3 - t2
        stage_times["cnn_crop_shape"] = list(true_shape)
    return out
