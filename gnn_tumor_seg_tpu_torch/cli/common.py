"""Shared CLI helpers: checkpoint-driven model loading and the joint
GNN -> CNN per-sample prediction chain (counterpart of
gnn_tumor_seg_tpu/cli/common.py).

Two variants with the same output: `predict_one_sample_device` (the default)
keeps the GNN logits on the card and gathers the CNN's input crop there;
`predict_one_sample` materializes the voxel logits on the host, as the
reference does. The device variant also takes the device preprocessing
chain's outputs (ops/slic_device.py): the standardized volume left on the
card, whose channels it reads in place of an image upload, and the raw
supervoxel partition shipped before the background discard was known, with
the remap to node ids. The CNN crop is padded as the CNN trainer pads it
(train/cnn_trainer.py: `_CROP_BUCKET`, `default_crop_floor`, the JAX
package's bucket and floor): edge-replicated rows are not the same as the
conv's replicate padding near the crop face, so parity with the JAX
package needs the same padding. The JAX package's fixed serve
pad shape (`BRATS_RAW_SHAPE`) exists only to avoid XLA recompiles and pads
with background, so the port does not pad.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import spans
from ..config import DEFAULT_BACKGROUND_NODE_LOGITS
from ..ops.precision import compute_dtype, fast_precision
from ..runtime import resolve_device
from ..train.checkpoint import cnn_from_leaves, gnn_from_leaves, load_checkpoint
from ..train.cnn_trainer import (_CROP_BUCKET, combine_logits_and_image,
                                 default_crop_floor, pad_to_bucket)

__all__ = [
    "load_gnn_from_checkpoint", "load_cnn_from_checkpoint",
    "node_logits_to_voxel_logits", "predict_one_sample",
    "predict_one_sample_device", "resolve_slic_fn",
    "combine_logits_and_image", "pad_to_bucket", "default_crop_floor",
    "ship_partition",
]


def resolve_slic_fn(impl: str, device="cuda"):
    """Map a --slic_impl choice to a slic_fn for build_graph_sample.

    auto/native/numpy run the host canonical (data/slic.py); 'tpu' (the JAX
    package's name for its device SLIC) smooths and assigns on `device`, the
    card unless the caller asks for the CPU (ops/slic_device.py). Under
    "fast" precision that route rounds the standardized volume to bfloat16
    before the upload, as the JAX package does; the arithmetic stays
    float32."""
    if impl == "auto":
        return None
    if impl in ("native", "numpy"):
        from ..data.slic import slic_supervoxels

        return partial(slic_supervoxels, use_native=(impl == "native"))
    if impl == "tpu":
        from ..ops.slic_device import slic_supervoxels_device

        dev = resolve_device(device)

        def device_slic(image, **kw):
            if fast_precision() and "input_dtype" not in kw:
                kw["input_dtype"] = torch.bfloat16
            return slic_supervoxels_device(image, device=dev, **kw)

        return device_slic
    raise ValueError(f"unknown slic impl {impl!r}")


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


def ship_partition(sv_partition: np.ndarray, n_nodes: int,
                   device: torch.device) -> torch.Tensor:
    """Start the copy of a supervoxel partition to `device` (pinned,
    non_blocking), as int16 when the ids fit (half the bytes), so it streams
    while the host works on (JAX: pad_and_ship_partition, without its pad
    to the fixed serve shape)."""
    dtype = (np.int16 if n_nodes < np.iinfo(np.int16).max
             else sv_partition.dtype)
    t = torch.from_numpy(np.ascontiguousarray(sv_partition.astype(dtype, copy=False)))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def predict_one_sample_device(gnn_forward, cnn_forward, graph,
                              img: np.ndarray | None, sv_partition: np.ndarray,
                              stage_times: dict | None = None, vol_t=None,
                              sv_raw_dev=None, sv_remap=None) -> np.ndarray:
    """Joint chain with the GNN logits kept on the card (same output as
    `predict_one_sample`). The host uploads the int16 supervoxel partition
    and the 4-channel image (bf16 under "fast"); voxel gather, argmax,
    cross dilation and the per-axis tumor masks run on the card; the host
    pulls three small axis masks to choose the crop, and three index_selects
    on the card build the CNN input. Returns int16 labels in training id
    space.

    From the device preprocessing chain: vol_t, the standardized volume
    [C, X, Y, Z] on the card, gives the image channels (`img` is then
    unused); sv_raw_dev, the raw partition already on the card, is read
    through sv_remap (raw supervoxel id -> node id, -1 = discarded
    background) applied on the card. -1 in either partition maps to the
    appended background row explicitly."""
    st = stage_times
    with spans.span("serve.gnn_forward", st, "gnn_forward"):
        node_logits = gnn_forward(graph)[0].float()              # [Nmax, C]
        dev = node_logits.device
        n_max = node_logits.shape[0]
        bg = torch.from_numpy(_background_row(node_logits.shape[-1])).to(dev)
        table = torch.cat([node_logits, bg], 0)                  # [Nmax+1, C]
        if sv_raw_dev is not None:
            remap = torch.from_numpy(np.asarray(sv_remap, np.int64)).to(dev)
            table = torch.cat([table[torch.where(remap < 0, n_max, remap)], bg], 0)
            sv = sv_raw_dev
        else:
            sv = ship_partition(sv_partition, int(graph.n_nodes[0]), dev)
        idx = torch.where(sv < 0, table.shape[0] - 1, sv.long())
        vox = table[idx]                                         # [X, Y, Z, C]
        mx, my, mz = (m.cpu().numpy() for m in
                      _dilated_axis_masks(vox.argmax(-1) != 0))
    with spans.span("serve.crop_and_prep", st, "crop_and_prep"):
        fl = default_crop_floor() or (0, 0, 0)
        ix, nx, rx = _axis_indices(mx, _CROP_BUCKET, floor=fl[0])
        iy, ny, ry = _axis_indices(my, _CROP_BUCKET, floor=fl[1])
        iz, nz, rz = _axis_indices(mz, _CROP_BUCKET, floor=fl[2])
        cd = compute_dtype()
        if vol_t is not None:
            img_dev = vol_t.permute(1, 2, 3, 0)
        else:
            # under "fast" the image goes up as bf16, as the JAX package ships it
            img_dev = torch.from_numpy(np.ascontiguousarray(img, np.float32))
            img_dev = img_dev.to(cd).to(dev).float()
        x = torch.cat([img_dev, vox], -1)
        x = x.index_select(0, torch.from_numpy(ix).to(dev))
        x = x.index_select(1, torch.from_numpy(iy).to(dev))
        x = x.index_select(2, torch.from_numpy(iz).to(dev)).to(cd)
        if st is not None:      # the stage ends when its device work does
            _sync(dev)
    with spans.span("serve.cnn_forward", st, "cnn_forward"):
        refined = cnn_forward(x[None])[0]
        preds = refined.argmax(-1).to(torch.int16).cpu().numpy()
    preds = preds[:nx, :ny, :nz]
    out = np.zeros_like(sv_partition, dtype=np.int16)
    out[np.ix_(rx, ry, rz)] = preds
    if st is not None:
        st["cnn_crop_shape"] = [nx, ny, nz]
    return out


def predict_one_sample(gnn_forward, cnn_forward, graph, img: np.ndarray,
                       sv_partition: np.ndarray,
                       stage_times: dict | None = None) -> np.ndarray:
    """Joint GNN -> CNN chain for one brain, host-materialized
    (`scripts/generate_joint_predictions.py:59-73`): GNN node logits -> voxel
    logits -> tumor crop -> CNN refinement -> argmax embedded into the full
    (cropped-brain) volume. Returns int16 labels in training id space."""
    from ..data.image import determine_tumor_crop

    st = stage_times
    with spans.span("serve.gnn_forward", st, "gnn_forward"):
        node_logits = gnn_forward(graph)[0].float().cpu().numpy()
        node_logits = node_logits[: int(graph.n_nodes[0])]
    with spans.span("serve.crop_and_prep", st, "crop_and_prep"):
        voxel_logits = node_logits_to_voxel_logits(node_logits, sv_partition)
        tumor_crop = determine_tumor_crop(voxel_logits.argmax(-1))
        x = combine_logits_and_image(voxel_logits, img, tumor_crop)
        true_shape = x.shape[:3]
        x, _ = pad_to_bucket(x, floor=default_crop_floor())
        # under "fast" the CNN computes in bf16 anyway: cast before the upload
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(compute_dtype())
    with spans.span("serve.cnn_forward", st, "cnn_forward"):
        refined = cnn_forward(x[None])[0]
        preds = refined.argmax(-1).to(torch.int16).cpu().numpy()
    preds = preds[: true_shape[0], : true_shape[1], : true_shape[2]]
    out = np.zeros_like(sv_partition, dtype=np.int16)
    out[tumor_crop] = preds
    if st is not None:
        st["cnn_crop_shape"] = list(true_shape)
    return out
