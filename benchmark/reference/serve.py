"""Plain reference of one serve request, stage by stage, in torch on the
device (float64 unless a control's precision says otherwise).

The reference brain pipeline (`mri2graph/graphgen.py`,
`data_processing/image_processing.py` of the published code): crop the
brain (planes where every modality is 0 dropped), scale each modality by
its 0.995 quantile and standardize with the BraTS-2021 statistics, smooth
(Gaussian, sigma 1, radius 4, mirrored edges), SLIC in its blockwise form
(centres on a grid of ~n_segments cells, each voxel choosing among the 27
cells around its own, 10 rounds), connectivity (each cell's largest
6-connected piece kept, the other pieces absorbed by their neighbours, ids
made contiguous), node features (five quantiles of each
modality over each supervoxel), background supervoxels dropped, regular kNN
edges over centroids, the GNN, the voxel logits (background row [1, -1,
-1, -1]), the tumour crop (dilated predicted tumour, each axis padded up to
a multiple of 16 and at least to the floor by repeating its last plane),
the refinement CNN (two 5^3 convolutions with replicate padding), and the
labels mapped to BraTS ids.

Each stage is a function; `judge` compares a record of what a request
produced with the reference computed from that record's previous stage,
and `control_record` runs the whole chain in a lower precision and returns
such a record, which `judge` then compares the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..inputs import regular_knn
from . import gnn as gnn_ref
from .precision import REFERENCE, REFERENCE_F32, Precision

STD_MEAN = (0.4645, 0.6625, 0.4064, 0.3648)   # BraTS-2021 healthy tissue
STD_STD = (0.1593, 0.1703, 0.1216, 0.1627)
QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)
BACKGROUND_LOGITS = (1.0, -1.0, -1.0, -1.0)
TRAIN_TO_BRATS = (0, 2, 1, 4)                 # training ids -> BraTS ids
CROP_BUCKET = 16


# ----------------------------------------------------------------- volume
def brain_crop(raw: np.ndarray):
    """Index arrays (x, y, z) of the planes where some modality is non-zero;
    raw [C, X, Y, Z]."""
    mask = raw.max(axis=0) > 0.01
    return tuple(np.nonzero(mask.any(axis=tuple(a for a in range(3) if a != ax)))[0]
                 for ax in range(3))


def take(vol, idx):
    """vol[..., x, y, z] at the index arrays idx (np.ix_ over the last three
    axes)."""
    ix, iy, iz = idx
    return vol[..., ix[:, None, None], iy[None, :, None], iz[None, None, :]]


def standardize(crop_raw: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[C, X, Y, Z] raw -> standardized: x / q995 per modality (linear
    interpolation between order statistics), then (. - mean) / std."""
    x = prec.round(crop_raw.to(prec.dtype))
    C = x.shape[0]
    flat = x.reshape(C, -1).sort(dim=1).values
    pos = (flat.shape[1] - 1) * 0.995
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo
    q = flat[:, lo] * (1 - frac) + flat[:, hi] * frac
    mean = torch.tensor(STD_MEAN, dtype=x.dtype, device=x.device).view(C, 1, 1, 1)
    std = torch.tensor(STD_STD, dtype=x.dtype, device=x.device).view(C, 1, 1, 1)
    return prec.round((x / q.view(C, 1, 1, 1) - mean) / std)


def smooth(vol: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian over the three spatial axes of [C, X, Y, Z],
    radius int(4 sigma + 0.5), mirrored edges (d c b a | a b c d)."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w /= w.sum()
    out = vol
    for axis in (1, 2, 3):
        n = out.shape[axis]
        j = np.arange(-r, n + r)
        j = np.where(j < 0, -j - 1, j)
        j = np.where(j >= n, 2 * n - 1 - j, j)
        padded = out.index_select(axis, torch.from_numpy(j).to(out.device))
        acc = torch.zeros_like(out)
        for k in range(len(w)):
            acc = acc + padded.narrow(axis, k, n) * float(w[k])
        out = acc
    return out


def slic_grid(shape, n_segments: int):
    X, Y, Z = shape
    step = (X * Y * Z / max(n_segments, 1)) ** (1.0 / 3.0)
    return tuple(max(1, int(round(s / step))) for s in shape), step


def slic_cells(vol: torch.Tensor, n_segments: int, compactness: float,
               max_iter: int = 10) -> torch.Tensor:
    """SLIC cell ids [X, Y, Z] (int64) of a smoothed [C, X, Y, Z] volume,
    before connectivity: numbering (cx * gy + cy) * gz + cz of the grid
    cells; a voxel takes the nearest of the 27 candidate centres around its
    own cell, D = |colour|^2 / m^2 + |position|^2 / step^2; centres are the
    means of their voxels (an empty cell's centre is 0)."""
    C, X, Y, Z = vol.shape
    dev, dt = vol.device, vol.dtype
    (gx, gy, gz), step = slic_grid((X, Y, Z), n_segments)
    n = gx * gy * gz

    def cell_of(extent, g):
        return torch.clamp((torch.arange(extent, device=dev) * g) // extent, max=g - 1)

    cx, cy, cz = cell_of(X, gx), cell_of(Y, gy), cell_of(Z, gz)
    own = ((cx[:, None, None] * gy + cy[None, :, None]) * gz
           + cz[None, None, :]).reshape(-1)
    pos = torch.stack(torch.meshgrid(
        *[torch.arange(s, device=dev, dtype=dt) for s in (X, Y, Z)],
        indexing="ij"), -1).reshape(-1, 3)
    feats = torch.cat([vol.reshape(C, -1).t(), pos], 1)           # [V, C + 3]

    def centers(assign):
        cnt = torch.bincount(assign, minlength=n).clamp(min=1).to(dt)
        acc = torch.zeros((n, C + 3), dtype=dt, device=dev).index_add_(0, assign, feats)
        return acc / cnt[:, None]

    g = torch.arange(n, device=dev)
    gcx, gcy, gcz = g // (gy * gz), (g // gz) % gy, g % gz
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dz in (-1, 0, 1)
               for dy in (-1, 0, 1)]
    inv_m2 = 1.0 / max(compactness, 1e-8) ** 2
    inv_s2 = 1.0 / step ** 2
    ctr = centers(own)
    assign = own
    for it in range(max_iter):
        best = torch.full((own.numel(),), math.inf, dtype=dt, device=dev)
        best_c = own.clone()
        for dx, dy, dz in offsets:
            ncx, ncy, ncz = gcx + dx, gcy + dy, gcz + dz
            valid = ((ncx >= 0) & (ncx < gx) & (ncy >= 0) & (ncy < gy)
                     & (ncz >= 0) & (ncz < gz))
            cand = torch.where(valid, (ncx * gy + ncy) * gz + ncz, 0)[own]
            c = ctr[cand]
            d = ((feats[:, :C] - c[:, :C]) ** 2).sum(1) * inv_m2 \
                + ((feats[:, C:] - c[:, C:]) ** 2).sum(1) * inv_s2
            d = torch.where(valid[own], d, math.inf)
            hit = d < best
            best = torch.where(hit, d, best)
            best_c = torch.where(hit, cand, best_c)
        assign = best_c
        if it + 1 < max_iter:
            ctr = centers(assign)
    return assign.view(X, Y, Z)


def relabel(labels: torch.Tensor) -> torch.Tensor:
    """Ids made contiguous from 0 in increasing order."""
    _, inv = torch.unique(labels, return_inverse=True)
    return inv


def _neighbour(vol: torch.Tensor, axis: int, side: int, fill) -> torch.Tensor:
    """vol's value at the voxel one step along `axis` (side -1: the lower
    neighbour, +1: the upper), `fill` where that voxel lies outside."""
    out = torch.full_like(vol, fill)
    n = vol.shape[axis]
    if side < 0:
        out.narrow(axis, 1, n - 1).copy_(vol.narrow(axis, 0, n - 1))
    else:
        out.narrow(axis, 0, n - 1).copy_(vol.narrow(axis, 1, n - 1))
    return out


# the order in which a fragment's voxel looks at its neighbours
_SIDES = [(axis, side) for axis in range(3) for side in (-1, 1)]


def components(labels: torch.Tensor) -> torch.Tensor:
    """Each voxel's 6-connected component of equal labels, named by the
    component's first voxel in C order (its flat index)."""
    V = labels.numel()
    comp = torch.arange(V, device=labels.device).view(labels.shape)
    same = [_neighbour(labels, a, s, -1) == labels for a, s in _SIDES]
    while True:
        prev = comp
        for (a, s), eq in zip(_SIDES, same):
            nb = _neighbour(comp, a, s, V)
            comp = torch.where(eq & (nb < comp), nb, comp)
        flat = comp.reshape(-1)
        comp = flat[flat].view(labels.shape)          # pointer jumping
        if torch.equal(comp, prev):
            return comp


def connectivity(cells: torch.Tensor) -> torch.Tensor:
    """The supervoxels of SLIC cells [X, Y, Z]: each cell keeps its largest
    6-connected component (of equal size, the one reached first in C
    order); every other fragment is absorbed from its borders inward, in
    sweeps over the previous sweep's state, each voxel taking the region of
    its first neighbour, in the order x-1, x+1, y-1, y+1, z-1, z+1, that
    lies in a kept region; ids are then made contiguous."""
    labels = cells.long()
    V = labels.numel()
    comp = components(labels).reshape(-1)
    flat = labels.reshape(-1)
    size = torch.bincount(comp, minlength=V)
    roots = torch.nonzero(comp == torch.arange(V, device=comp.device)).view(-1)
    # the largest component of each cell, the first of equal ones
    key = size[roots] * V + (V - 1 - roots)
    best = torch.full((int(flat.max()) + 1,), -1, dtype=torch.long,
                      device=comp.device).scatter_reduce(
        0, flat[roots], key, "amax", include_self=True)
    kept_root = torch.zeros(V, dtype=torch.bool, device=comp.device)
    kept_root[V - 1 - best[best >= 0] % V] = True
    comp = comp.view(labels.shape)
    kept = kept_root[comp]
    while not bool(kept.all()):
        take = torch.zeros_like(kept)
        new = comp
        for a, s in _SIDES:
            nb_kept = _neighbour(kept, a, s, False)
            hit = ~kept & ~take & nb_kept
            new = torch.where(hit, _neighbour(comp, a, s, 0), new)
            take |= hit
        if not bool(take.any()):
            break                       # fragments with no kept region near
        comp, kept = new, kept | take
    return relabel(flat[comp.reshape(-1)].view(labels.shape))


# ------------------------------------------------------------------ graph
def segment_quantiles(values: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """[n_seg, 5] linear-interpolation quantiles of values within each
    segment (0 for an empty one)."""
    order = torch.argsort(values, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    sv = values[order]
    counts = torch.bincount(seg, minlength=n_seg)
    starts = torch.cumsum(counts, 0) - counts
    q = torch.tensor(QUANTILES, dtype=torch.float64, device=values.device)
    posq = (counts[:, None] - 1).clamp(min=0).double() * q[None, :]
    lo, hi = posq.floor().long(), posq.ceil().long()
    frac = (posq - lo.double()).to(values.dtype)
    out = sv[starts[:, None] + lo] * (1 - frac) + sv[starts[:, None] + hi] * frac
    return torch.where(counts[:, None] > 0, out, torch.zeros_like(out))


def graph_features(std_vol: torch.Tensor, sv: torch.Tensor, prec: Precision):
    """From a final partition sv [X, Y, Z] (ids 0..S-1) and the standardized
    volume: (features [N, 20], centroids [N, 3], remap [S] raw id -> node id
    or -1) after dropping the background supervoxels, whose 0.9 quantile of
    the first modality lies within 0.01 of the lowest."""
    C = std_vol.shape[0]
    seg = sv.reshape(-1).long()
    n_seg = int(seg.max()) + 1
    feats = torch.cat([segment_quantiles(std_vol[c].reshape(-1), seg, n_seg)
                       for c in range(C)], 1)
    X, Y, Z = sv.shape
    pos = torch.stack(torch.meshgrid(
        *[torch.arange(s, device=sv.device, dtype=torch.float64) for s in (X, Y, Z)],
        indexing="ij"), -1).reshape(-1, 3)
    cnt = torch.bincount(seg, minlength=n_seg).clamp(min=1).double()
    cent = torch.zeros((n_seg, 3), dtype=torch.float64, device=sv.device
                       ).index_add_(0, seg, pos) / cnt[:, None]
    top = feats[:, len(QUANTILES) - 1]
    keep = ~(top < top.min() + 0.01)
    remap = torch.full((n_seg,), -1, dtype=torch.long, device=sv.device)
    remap[keep] = torch.arange(int(keep.sum()), device=sv.device)
    return prec.round(feats[keep]), prec.round(cent[keep]), remap


def one_graph(feats: torch.Tensor) -> torch.Tensor:
    """The graph index of a request's nodes: one graph, all zeros."""
    return torch.zeros(feats.shape[0], dtype=torch.int64, device=feats.device)


def knn_violations(cent: torch.Tensor, src, dst, k: int, tol: float = 1e-5) -> float:
    """Share of nodes whose edges break the regular kNN rule, judged on the
    edges as given: node i, reached in index order with the degree the
    lower-index nodes gave it, links to exactly its remaining need of
    higher-index nodes, and those are its nearest ones (a distance within
    `tol` of the last one needed counts as a tie). The greedy rule cascades
    through the degrees, so a near-tie broken the other way changes later
    choices; judging each node on the choices made before it keeps such
    ties from counting as errors."""
    n = cent.shape[0]
    dev = cent.device
    a = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    b = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    pair = torch.unique(lo * n + hi)
    lo, hi = pair // n, pair % n
    sym = set(zip(a.tolist(), b.tolist()))
    if len(sym) != 2 * pair.numel() or (lo == hi).any():
        return math.inf                       # not stored both ways, or a loop
    c = cent.double()
    d = ((c[lo] - c[hi]) ** 2).sum(1)
    chosen = torch.bincount(lo, minlength=n)
    before = torch.bincount(hi, minlength=n)
    far = torch.zeros(n, dtype=torch.float64, device=dev).scatter_reduce(
        0, lo, d, "amax", include_self=True)
    dd = torch.cdist(c, c) ** 2
    dd.masked_fill_(torch.ones(n, n, dtype=torch.bool, device=dev).tril(), math.inf)
    near = dd.topk(min(k, max(n - 1, 1)), largest=False).values   # [n, k]
    del dd
    higher = torch.arange(n - 1, -1, -1, device=dev)
    need = torch.minimum((k - before).clamp(min=0), higher)
    m = chosen.clamp(min=1, max=near.shape[1]) - 1
    last = near.gather(1, m[:, None])[:, 0]
    bad = (chosen != need) | ((chosen > 0) & (far > last * (1 + tol)))
    return float(bad.double().mean())


# -------------------------------------------------------------------- CNN
def voxel_logits(node_logits: torch.Tensor, partition: torch.Tensor) -> torch.Tensor:
    """[X, Y, Z, C] logits of each voxel's node, the background row where
    the partition is -1."""
    bg = torch.tensor(BACKGROUND_LOGITS, dtype=node_logits.dtype,
                      device=node_logits.device)[None]
    table = torch.cat([node_logits, bg], 0)
    idx = torch.where(partition < 0, table.shape[0] - 1, partition.long())
    return table[idx]


def tumor_crop_indices(vox: torch.Tensor, floor):
    """Per axis: (padded indices, true length, true indices) of the crop
    around the predicted tumour dilated by the 3-D cross; an axis with no
    tumour keeps all of it."""
    m = vox.argmax(-1) != 0
    d = m.clone()
    d[1:] |= m[:-1]
    d[:-1] |= m[1:]
    d[:, 1:] |= m[:, :-1]
    d[:, :-1] |= m[:, 1:]
    d[:, :, 1:] |= m[:, :, :-1]
    d[:, :, :-1] |= m[:, :, 1:]
    out = []
    for ax, f in zip(range(3), floor):
        other = tuple(a for a in range(3) if a != ax)
        idx = torch.nonzero(d.any(dim=other[1]).any(dim=other[0])).view(-1).cpu().numpy()
        if idx.size == 0:
            idx = np.arange(d.shape[ax])
        n = idx.size
        length = max(-(-n // CROP_BUCKET) * CROP_BUCKET, f)
        padded = np.concatenate([idx, np.full(length - n, idx[-1])])
        out.append((padded, n, idx))
    return out


def cnn_input(std_vol: torch.Tensor, vox: torch.Tensor, crop) -> torch.Tensor:
    """[X', Y', Z', 8]: the standardized modalities and the voxel logits at
    the crop's (padded) indices."""
    x = torch.cat([std_vol.permute(1, 2, 3, 0).to(vox.dtype), vox], -1)
    return take(x.permute(3, 0, 1, 2), [torch.from_numpy(c[0]).to(x.device)
                                        for c in crop]).permute(1, 2, 3, 0)


def _replicate_pad(x: torch.Tensor, p: int = 2) -> torch.Tensor:
    return torch.nn.functional.pad(x, (p, p, p, p, p, p), mode="replicate")


def cnn_forward(w: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[X, Y, Z, 8] -> [X, Y, Z, 4] logits: conv 5^3 (replicate padding 2),
    ReLU, conv 5^3, computed in planes of X so the device holds a block at
    a time."""
    dt = prec.dtype
    w0, b0 = prec.round(w["w0"].to(dt)), prec.round(w["b0"].to(dt))
    w1, b1 = prec.round(w["w1"].to(dt)), prec.round(w["b1"].to(dt))
    xin = _replicate_pad(prec.round(x.to(dt)).permute(3, 0, 1, 2)[None])
    X = x.shape[0]
    out = []
    block = 32
    with prec.math(), torch.no_grad():
        h = prec.round(torch.relu(torch.nn.functional.conv3d(xin, w0, b0)))
        h = _replicate_pad(h)
        for s in range(0, X, block):
            e = min(X, s + block)
            out.append(torch.nn.functional.conv3d(h[:, :, s:e + 4], w1, b1))
    return torch.cat(out, 2)[0].permute(1, 2, 3, 0)


# ------------------------------------------------------------------ judge
def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.double(), b.double()
    if a.shape != b.shape:
        return math.inf
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def judge(rec: dict, raw: np.ndarray, config: dict, weights: dict,
          cnn_weights: dict, params: dict, device) -> dict:
    """The numbers compared for one request. `rec` holds what the request
    produced: `std` (standardized crop [C, X, Y, Z]), `cells` (SLIC cell ids
    before connectivity), `partition` (the final supervoxel ids), `feats`,
    `src`, `dst` (the graph the GNN read), `node_logits`, `cnn_x` (the CNN's
    input), `cnn_logits`, `labels` (full-size BraTS ids). `raw` is the
    brain [C, 240, 240, 155] both sides were given."""
    checks = {}
    crop = brain_crop(raw)
    raw_crop = torch.from_numpy(take(raw, crop).astype(np.float32)).to(device)
    std = standardize(raw_crop, REFERENCE)
    checks["std_err"] = _rel(rec["std"], std)
    cells = slic_cells(smooth(std), params["num_nodes"], params["boxiness"])
    prog_cells = torch.as_tensor(np.asarray(rec["cells"]), device=device).long()
    checks["slic_mismatch"] = (float((prog_cells != cells).double().mean())
                               if prog_cells.shape == cells.shape else math.inf)
    del cells
    part = torch.as_tensor(np.asarray(rec["partition"]), device=device).long()
    # the connectivity pass, judged on the program's own SLIC cells
    want = connectivity(prog_cells)
    checks["partition_mismatch"] = (float((part != want).double().mean())
                                    if part.shape == want.shape else math.inf)
    del want, prog_cells
    feats, cent, remap = graph_features(std, part, REFERENCE)
    checks["feat_err"] = _rel(torch.as_tensor(np.asarray(rec["feats"])), feats.cpu())
    n = feats.shape[0]
    checks["knn_violations"] = (knn_violations(cent, rec["src"], rec["dst"], params["k"])
                                if len(rec["feats"]) == n else math.inf)
    # the GNN on the graph the program read
    pf = torch.as_tensor(np.asarray(rec["feats"]), device=device)
    ps = torch.as_tensor(np.asarray(rec["src"]), device=device).long()
    pd = torch.as_tensor(np.asarray(rec["dst"]), device=device).long()
    with torch.no_grad():
        logits = gnn_ref.forward(config, weights, pf, ps, pd, one_graph(pf),
                                 REFERENCE)
    node_logits = torch.as_tensor(rec["node_logits"], device=device)[:logits.shape[0]]
    checks["gnn_err"] = _rel(node_logits, logits)
    # the CNN input from the program's partition and node logits
    node_part = torch.where(part >= 0, remap[part.clamp(min=0)], -1)
    vox = voxel_logits(node_logits.double(), node_part)
    cnn_crop = tumor_crop_indices(vox, params["crop_floor"])
    x = cnn_input(std, vox, cnn_crop)
    px = torch.as_tensor(rec["cnn_x"], device=device)
    checks["cnn_in_err"] = _rel(px, x)
    del x, vox
    ref_logits = cnn_forward(cnn_weights, px.float(), REFERENCE_F32)
    checks["cnn_err"] = _rel(torch.as_tensor(rec["cnn_logits"], device=device),
                             ref_logits)
    checks["label_gap"] = label_gap(rec["labels"], ref_logits, cnn_crop, crop,
                                    raw.shape[1:])
    return checks


def label_gap(labels: np.ndarray, ref_logits: torch.Tensor, cnn_crop, crop,
              shape) -> float:
    """The widest gap, over the voxels of the tumour crop, between the
    reference's best logit and its logit of the label served there, over
    the largest logit; inf where a voxel outside the crop is not 0 or a
    label is no BraTS id."""
    labels = np.asarray(labels)
    if labels.shape != tuple(shape):
        return math.inf
    brats_to_train = np.full(5, -1, np.int64)
    for t, b in enumerate(TRAIN_TO_BRATS):
        brats_to_train[b] = t
    if labels.min() < 0 or labels.max() > 4:
        return math.inf
    train = brats_to_train[labels.astype(np.int64)]
    if (train < 0).any():
        return math.inf
    (px, nx, rx), (py, ny, ry), (pz, nz, rz) = cnn_crop
    inside = np.zeros(shape, bool)
    gx, gy, gz = crop[0][rx], crop[1][ry], crop[2][rz]
    inside[np.ix_(gx, gy, gz)] = True
    if train[~inside].any():
        return math.inf
    served = torch.from_numpy(train[np.ix_(gx, gy, gz)]).to(ref_logits.device)
    lg = ref_logits[:nx, :ny, :nz].double()
    gap = lg.max(-1).values - torch.gather(lg, -1, served[..., None])[..., 0]
    return float(gap.max() / lg.abs().max().clamp_min(1e-30))


def control_record(raw: np.ndarray, config: dict, weights: dict,
                   cnn_weights: dict, params: dict, prec: Precision,
                   device) -> dict:
    """The whole chain in `prec`, as a record for `judge`."""
    crop = brain_crop(raw)
    raw_crop = torch.from_numpy(take(raw, crop).astype(np.float32)).to(device)
    std = standardize(raw_crop, prec)
    sm = prec.round(smooth(std))
    cells = slic_cells(sm, params["num_nodes"], params["boxiness"])
    del sm
    part = connectivity(cells)
    feats, cent, remap = graph_features(std, part, prec)
    src, dst = regular_knn(cent.double(), params["k"])
    f = feats.to(prec.dtype)
    with torch.no_grad():
        logits = gnn_ref.forward(config, weights, f,
                                 torch.from_numpy(src).to(device),
                                 torch.from_numpy(dst).to(device), one_graph(f),
                                 prec).float()
    node_part = torch.where(part >= 0, remap[part], -1)
    vox = voxel_logits(logits.double(), node_part)
    cnn_crop = tumor_crop_indices(vox, params["crop_floor"])
    x = cnn_input(std.double(), vox, cnn_crop).float()
    out = cnn_forward(cnn_weights, x, prec).float()
    pred = out.argmax(-1).cpu().numpy()
    (px, nx, rx), (py, ny, ry), (pz, nz, rz) = cnn_crop
    full = np.zeros(raw.shape[1:], np.int64)
    full[np.ix_(crop[0][rx], crop[1][ry], crop[2][rz])] = pred[:nx, :ny, :nz]
    return {"std": std.float(), "cells": cells.cpu().numpy(),
            "partition": part.cpu().numpy(), "feats": feats.float().cpu().numpy(),
            "src": src, "dst": dst, "node_logits": logits, "cnn_x": x,
            "cnn_logits": out,
            "labels": np.asarray(TRAIN_TO_BRATS)[full].astype(np.int16)}
