"""Inputs of the benchmark, made from the run's seed on the run's device.

Nothing here imports the program. The same seed gives the same inputs, and
every seed gives inputs of the same sizes (brain and crop extents, node and
degree buckets), so seeds change the values and never the work.

- `make_brain`: a synthetic BraTS brain, four int16 modalities 240x240x155
  with an ellipsoid brain and a three-class spherical tumour (a copy of the
  brain of chip_smoke.make_brain, drawn on the device).
- `write_nifti_gz`: a plain NIfTI-1 writer for those volumes.
- `make_train_graph`: one supervoxel graph of the training cells, kNN edges
  over jittered grid centroids with the regular top-up of the BraTS
  preprocessing, features correlated with four labels.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import os
import struct

import numpy as np
import torch

BRATS_SHAPE = (240, 240, 155)
MODALITIES = ("flair", "t1", "t1ce", "t2")
# per-class intensity offsets of each modality (chip_smoke.make_brain)
_CLASS_OFFSETS = {2: (200, 60, 40, 160), 1: (90, 40, -120, 70),
                  4: (110, 70, 260, 90)}


def seed_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one stream of draws of the run's seed; a
    seed of any size maps into the generator's 64-bit state."""
    mixed = np.random.SeedSequence([int(seed) % 2**63, stream]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(mixed[0]) << 32 | int(mixed[1]))
    return g


def make_brain(gen: torch.Generator, shape=BRATS_SHAPE,
               radii=(36.0, 24.0, 12.0), radius_jitter: float = 0.15,
               center_shift: int = 10, tumor_shift: int = 40):
    """Four int16 modalities [C, X, Y, Z] on gen's device, and the BraTS
    label volume. The brain's centre moves by up to `center_shift`, the
    tumour's by up to `tumor_shift` voxels, and the tumour radii are drawn
    within `radius_jitter` of `radii`; the brain's extent is fixed, so every
    brain has the same crop."""
    dev = gen.device
    shape_t = torch.tensor(shape, dtype=torch.float32, device=dev)
    center = shape_t / 2 + torch.randint(-center_shift, center_shift + 1, (3,),
                                         generator=gen, device=dev)
    tumor_c = center + torch.randint(-tumor_shift, tumor_shift + 1, (3,),
                                     generator=gen, device=dev)
    scale = 1 + radius_jitter * (2 * torch.rand((), generator=gen, device=dev) - 1)
    axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in shape]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    half = shape_t / 2.4
    r = (((gx - center[0]) / half[0]) ** 2 + ((gy - center[1]) / half[1]) ** 2
         + ((gz - center[2]) / half[2]) ** 2).sqrt()
    brain = r < 1.0
    tr = ((gx - tumor_c[0]) ** 2 + (gy - tumor_c[1]) ** 2
          + (gz - tumor_c[2]) ** 2).sqrt()
    labels = torch.zeros(shape, dtype=torch.int16, device=dev)
    for cls, rad in zip((2, 1, 4), radii):
        labels[(tr < rad * scale) & brain] = cls
    base = torch.randint(0, 80, (4, *shape), generator=gen, device=dev,
                         dtype=torch.int16)
    noise = torch.randint(-20, 21, (4, *shape), generator=gen, device=dev,
                          dtype=torch.int16)
    mods = torch.zeros((4, *shape), dtype=torch.int16, device=dev)
    for m in range(4):
        vol = (300 + 60 * m + base[m]) * brain
        for cls, off in _CLASS_OFFSETS.items():
            sel = labels == cls
            vol = vol + sel * (off[m] + noise[m])
        mods[m] = vol.to(torch.int16)
    return mods, labels


def write_nifti_gz(vol: np.ndarray, path: str, level: int = 1) -> None:
    """A 3-D int16 volume as a single-file NIfTI-1 (.nii.gz), voxel order
    Fortran (x fastest), unit spacing, identity sform."""
    vol = np.asarray(vol)
    if vol.dtype != np.int16 or vol.ndim != 3:
        raise ValueError(f"expected a 3-D int16 volume, got {vol.dtype} {vol.shape}")
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *vol.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 4)            # DT_INT16
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    for row in range(3):
        srow = [0.0] * 4
        srow[row] = 1.0
        struct.pack_into("<4f", hdr, 280 + 16 * row, *srow)
    hdr[344:348] = b"n+1\x00"
    body = np.asfortranarray(vol).tobytes(order="F")
    with open(path, "wb") as f:
        f.write(gzip.compress(bytes(hdr) + b"\x00" * 4 + body, compresslevel=level))


def write_brain_dir(mods: np.ndarray, directory: str, name: str = "brain") -> str:
    """The four modalities [C, X, Y, Z] as `<name>_<modality>.nii.gz` in
    `directory` (gzip in parallel threads: zlib releases the GIL)."""
    os.makedirs(directory, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(MODALITIES)) as pool:
        list(pool.map(lambda m: write_nifti_gz(
            mods[m], os.path.join(directory, f"{name}_{MODALITIES[m]}.nii.gz")),
            range(len(MODALITIES))))
    return directory


def regular_knn(pos: torch.Tensor, k: int):
    """The regular kNN adjacency of the BraTS preprocessing: nodes in index
    order top their degree up to k with their nearest not-yet-linked
    higher-index nodes; edges are stored both ways. Returns numpy (src,
    dst) int64."""
    n = pos.shape[0]
    d = torch.cdist(pos.double(), pos.double())
    d.masked_fill_(torch.ones(n, n, dtype=torch.bool, device=pos.device).tril(),
                   float("inf"))
    vals, idx = d.topk(min(k, n - 1), largest=False)
    cand, ok = idx.cpu().numpy(), torch.isfinite(vals).cpu().numpy()
    del d
    deg = np.zeros(n, np.int64)
    src, dst = [], []
    for i in range(n):
        need = k - deg[i]
        if need <= 0:
            continue
        c = cand[i][ok[i]][:need]
        deg[c] += 1
        deg[i] += len(c)
        src.append(np.full(len(c), i))
        dst.append(c)
    a, b = np.concatenate(src), np.concatenate(dst)
    return np.concatenate([a, b]), np.concatenate([b, a])


def make_train_graph(gen: torch.Generator, n_nodes: int = 7000,
                     grid=(20, 20, 18), k: int = 10, n_feats: int = 20,
                     jitter: float = 0.3, noise: float = 0.3):
    """One training graph: `n_nodes` of the grid's cells (in raster order,
    as supervoxel ids run) with jittered centroids, labels 0-3 by distance
    from a random tumour centre, features class means plus noise, regular
    kNN edges. Returns numpy (feats f32 [N, F], src, dst, labels int32)."""
    dev = gen.device
    axes = [torch.arange(s, device=dev, dtype=torch.float32) for s in grid]
    pos = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3) + 0.5
    pos = pos + jitter * torch.randn(pos.shape, generator=gen, device=dev)
    keep = torch.randperm(pos.shape[0], generator=gen, device=dev)[:n_nodes]
    pos = pos[keep.sort().values]
    g = torch.tensor(grid, dtype=torch.float32, device=dev)
    center = g * (0.3 + 0.4 * torch.rand(3, generator=gen, device=dev))
    r = 0.3 * float(min(grid)) * (0.8 + 0.4 * torch.rand((), generator=gen, device=dev))
    dist = (pos - center).norm(dim=1)
    labels = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    labels[dist < r] = 1
    labels[dist < r * 0.66] = 2
    labels[dist < r * 0.33] = 3
    means = torch.randn((4, n_feats), generator=gen, device=dev)
    feats = means[labels] + noise * torch.randn((n_nodes, n_feats), generator=gen,
                                                device=dev)
    src, dst = regular_knn(pos, k)
    return (feats.float().cpu().numpy(), src, dst,
            labels.to(torch.int32).cpu().numpy())
