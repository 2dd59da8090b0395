"""Node-partitioned execution of one giant graph across ranks (counterpart
of gnn_tumor_seg_tpu/parallel/halo.py).

When a batched supervoxel graph is too big for one device, its nodes are
split contiguously over the ranks: each rank owns its nodes' features,
computes their layer outputs, and fetches its neighbours' rows from its
peers. The halo models run the port's own single-device layers
(models/sage.py `SageConv.forward`, models/gat.py `GatConv.forward`), and so
the Hopper kernels, on a B=1 GraphBatch over the rank's table, whose `rslot`
ops/graph.reciprocal_slots builds:

  p2p (`HaloGraphSageP2P` / `HaloGATP2P`)
      The rank's table lives in the extended-local index space
      [ W halo rows from rank r-1 | own `shard` rows | W from r+1 ].
      Per layer the rank sends its 2*W boundary rows to its ring neighbours
      (collectives.ring_exchange, in the compute dtype: bf16 in "fast", as
      JAX casts before the ppermute, :443), concatenates what it receives
      around its own rows, runs the conv and keeps its own rows. Halo rows
      list their neighbours restricted to the rank's own rows, so the table
      stays symmetric and reciprocal_slots accepts it (:15-27); the gradient
      of a halo row goes back to its home rank through the exchange's
      backward. Needs 1-shard edge locality (`partition_graph_p2p` raises
      otherwise). JAX pads the table to a multiple of 128 rows (a TPU
      alignment); those rows have no edge, and the halo models leave them
      out, so own-row outputs are the same.
  all_gather (`HaloGraphSage` / `HaloGAT`)
      The table is the full-graph square table, on every rank; the input
      features are gathered once (collectives.all_gather_rows) and the
      single-device model runs on the whole table on every rank, each
      keeping its own logits. Compute is replicated: it trains any edge
      structure and is not the scaling path.

The parameters are the single-device model's (`base`), so a checkpoint runs
on one device or partitioned. The loss is the global weighted
cross-entropy: numerator and denominator summed over ranks
(collectives.all_reduce_sum), the same scalar on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.gat import GAT
from ..models.sage import GraphSage, _dropout
from ..ops.graph import GraphBatch, reciprocal_slots
from ..ops.precision import compute_dtype
from ..train.losses import weighted_nll_terms
from .collectives import all_gather_rows, all_reduce_sum, ring_exchange
from .mesh import Mesh

__all__ = ["PartitionedGraph", "RankGraph", "partition_graph",
           "partition_graph_p2p", "place_partition", "HaloGraphSage",
           "HaloGraphSageP2P", "HaloGAT", "HaloGATP2P", "exchange_widths",
           "exchange_bytes_per_step"]


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """One giant graph, nodes split contiguously into n_parts shards (host
    numpy arrays, equal to the JAX package's).

    feats f32 [S, shard, F], node_mask f32 [S, shard], labels int32
    [S, shard] or None. The neighbour table: p2p [S, N_ext, D] in each
    shard's extended-local space (W | shard | W | pad); all_gather
    [N_tot, D] in padded-global ids, the same for every shard. nbr int32,
    nbr_mask and edge_weight f32."""

    nbr: np.ndarray
    nbr_mask: np.ndarray
    node_mask: np.ndarray
    feats: np.ndarray
    labels: np.ndarray | None
    edge_weight: np.ndarray | None = None

    @property
    def n_parts(self) -> int:
        return self.feats.shape[0]

    @property
    def shard_size(self) -> int:
        return self.feats.shape[1]

    @property
    def table_rows(self) -> int:
        return self.nbr.shape[-2]


def _align(x: int, q: int) -> int:
    return -(-x // q) * q


def _slot_fill(tab_rows, rows, vals, n_rows_per_tab: int, n_tabs: int,
               d_pad: int, weights=None):
    """Scatter (table, row, value[, weight]) edge entries into padded ELL
    tables [n_tabs, n_rows_per_tab, d_pad], slots in stable edge order per
    destination row (JAX halo.py:109)."""
    key = tab_rows.astype(np.int64) * n_rows_per_tab + rows
    order = np.argsort(key, kind="stable")
    ks = key[order]
    nbr = np.zeros((n_tabs * n_rows_per_tab, d_pad), np.int32)
    mask = np.zeros((n_tabs * n_rows_per_tab, d_pad), np.float32)
    w_tab = None
    if len(ks):
        starts = np.r_[0, np.flatnonzero(ks[1:] != ks[:-1]) + 1]
        sizes = np.diff(np.r_[starts, len(ks)])
        if sizes.max() > d_pad:
            raise ValueError(
                f"max degree {int(sizes.max())} exceeds degree padding {d_pad}")
        slot = np.arange(len(ks)) - np.repeat(starts, sizes)
        nbr[ks, slot] = vals[order]
        mask[ks, slot] = 1.0
        if weights is not None:
            w_tab = np.zeros((n_tabs * n_rows_per_tab, d_pad), np.float32)
            w_tab[ks, slot] = np.asarray(weights, np.float32)[order]
            w_tab = w_tab.reshape(n_tabs, n_rows_per_tab, d_pad)
    elif weights is not None:
        w_tab = np.zeros((n_tabs, n_rows_per_tab, d_pad), np.float32)
    return (nbr.reshape(n_tabs, n_rows_per_tab, d_pad),
            mask.reshape(n_tabs, n_rows_per_tab, d_pad), w_tab)


def _own_arrays(feats, labels, n_parts: int, per: int, shard: int):
    """[S, shard, ...] own-node feats/node_mask/labels from union arrays."""
    n, f_dim = feats.shape
    total = n_parts * shard
    idx = np.arange(n)
    pos = (idx // per) * shard + (idx % per)
    feats_p = np.zeros((total, f_dim), np.float32)
    feats_p[pos] = feats
    node_mask = np.zeros((total,), np.float32)
    node_mask[pos] = 1.0
    labels_p = None
    if labels is not None:
        lp = np.full((total,), -1, np.int32)
        lp[pos] = labels
        labels_p = lp.reshape(n_parts, shard)
    return (feats_p.reshape(n_parts, shard, f_dim),
            node_mask.reshape(n_parts, shard), labels_p)


def partition_graph(feats, src, dst, labels, n_parts: int,
                    shard_pad_to: int | None = None,
                    d_pad_to: int | None = None,
                    edge_weights=None) -> PartitionedGraph:
    """Host-side partition for the all_gather variant (JAX halo.py:165):
    own arrays shard contiguously; the table is the full-graph square ELL
    table in padded-global ids (node i -> (i // per) * shard + i % per).
    Works for any edge structure. shard_pad_to / d_pad_to pin the shapes
    over a sequence of partitioned batches."""
    n = feats.shape[0]
    per = -(-n // n_parts)
    shard = _align(per, 16)
    if shard_pad_to is not None:
        shard = max(shard, _align(shard_pad_to, 16))
    total = shard * n_parts
    deg = np.bincount(dst, minlength=n)
    d_pad = _align(max(int(deg.max(initial=0)), 1), 8)
    if d_pad_to is not None:
        d_pad = max(d_pad, d_pad_to)

    def to_padded(i):
        return (i // per) * shard + (i % per)

    nbr, mask, w_tab = _slot_fill(
        np.zeros(len(dst), np.int64), to_padded(np.asarray(dst, np.int64)),
        to_padded(np.asarray(src, np.int64)).astype(np.int32),
        total, 1, d_pad, weights=edge_weights)
    feats_p, node_mask, labels_p = _own_arrays(feats, labels, n_parts, per,
                                               shard)
    return PartitionedGraph(nbr=nbr[0], nbr_mask=mask[0], node_mask=node_mask,
                            feats=feats_p, labels=labels_p,
                            edge_weight=None if w_tab is None else w_tab[0])


def partition_graph_p2p(feats, src, dst, labels, n_parts: int,
                        shard_pad_to: int | None = None,
                        d_pad_to: int | None = None,
                        halo_pad_to: int | None = None,
                        edge_weights=None) -> tuple[PartitionedGraph, int]:
    """Contiguous node partition with boundary-only halo tables (JAX
    halo.py:220). Needs 1-shard locality: every edge joins nodes of the same
    or of adjacent shards, else ValueError (use partition_graph). Returns
    (PartitionedGraph, halo width W).

    Per-shard table (N_ext rows): [ last W rows of shard s-1 | own `shard`
    rows | first W rows of s+1 | zero pad to a 128 multiple ]. Own rows
    carry their full neighbour lists; halo rows carry theirs restricted to
    this shard's own rows, which keeps the table symmetric."""
    n = feats.shape[0]
    per = -(-n // n_parts)
    shard = _align(per, 16)
    if shard_pad_to is not None:
        shard = max(shard, _align(shard_pad_to, 16))

    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)

    def shard_of(i):
        return i // per

    def off_of(i):
        return i % per

    s_u, s_v = shard_of(src), shard_of(dst)
    jump = np.abs(s_u - s_v)
    if jump.max(initial=0) > 1:
        raise ValueError(
            "edges span non-adjacent shards; use partition_graph (all_gather)")
    from_left = s_u == s_v - 1
    from_right = s_u == s_v + 1
    need = 8
    if from_left.any():
        need = max(need, int((shard - off_of(src[from_left])).max()))
    if from_right.any():
        need = max(need, int((off_of(src[from_right]) + 1).max()))
    W = _align(need, 8)
    if halo_pad_to is not None:
        W = max(W, _align(halo_pad_to, 8))
    if W > shard:
        raise ValueError("halo wider than a shard; use partition_graph")
    n_ext = _align(2 * W + shard, 128)

    deg = np.bincount(dst, minlength=n)
    d_pad = _align(max(int(deg.max(initial=0)), 1), 8)
    if d_pad_to is not None:
        d_pad = max(d_pad, d_pad_to)

    def to_local(s_tab, ids):
        s_i, o = shard_of(ids), off_of(ids)
        return np.where(s_i == s_tab, W + o,
                        np.where(s_i == s_tab + 1, W + shard + o,
                                 W - (shard - o)))

    tabs = [s_v]
    rows = [W + off_of(dst)]
    vals = [to_local(s_v, src)]
    wts = [edge_weights] if edge_weights is not None else None
    cross = jump == 1
    if cross.any():
        cs, cd = src[cross], dst[cross]
        s_tab = shard_of(cs)
        rows_h = np.where(shard_of(cd) == s_tab - 1,
                          off_of(cd) - (shard - W),
                          W + shard + off_of(cd))
        if (rows_h < 0).any() or (rows_h >= 2 * W + shard).any():
            raise ValueError(
                "p2p partitioning requires a symmetric (undirected, both-"
                "direction) edge list")
        tabs.append(s_tab)
        rows.append(rows_h)
        vals.append(W + off_of(cs))
        if wts is not None:
            wts.append(np.asarray(edge_weights)[cross])
    tabs = np.concatenate(tabs)
    rows = np.concatenate(rows)
    vals = np.concatenate(vals).astype(np.int32)
    w_all = np.concatenate(wts) if wts is not None else None
    nbr, mask, w_tab = _slot_fill(tabs, rows, vals, n_ext, n_parts, d_pad,
                                  weights=w_all)
    feats_p, node_mask, labels_p = _own_arrays(feats, labels, n_parts, per,
                                               shard)
    pg = PartitionedGraph(nbr=nbr, nbr_mask=mask, node_mask=node_mask,
                          feats=feats_p, labels=labels_p, edge_weight=w_tab)
    return pg, W


# ---------------------------------------------------------------------------
# the rank's slice, on its device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankGraph:
    """What one rank holds of a PartitionedGraph, on its device: its own
    rows (feats [shard, F], node_mask [shard], labels [shard]) and its
    neighbour table as a B=1 GraphBatch with rslot (p2p: its extended table
    without the 128-row pad; all_gather: the full table)."""

    feats: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor | None
    table: GraphBatch


def place_partition(pg: PartitionedGraph, mesh: Mesh,
                    halo_width: int | None = None) -> RankGraph:
    """The rank's RankGraph of `pg` (p2p when pg's table has a shard axis,
    which needs its halo width). Builds the table's reciprocal slots, which
    raise on an asymmetric table."""
    if pg.n_parts != mesh.world_size:
        raise ValueError(f"graph has {pg.n_parts} shards for "
                         f"{mesh.world_size} ranks")
    r = mesh.rank
    ew = pg.edge_weight
    if pg.nbr.ndim == 3:
        if halo_width is None:
            raise ValueError("a p2p partition needs its halo width")
        rows = 2 * halo_width + pg.shard_size
        nbr, mask = pg.nbr[r, :rows], pg.nbr_mask[r, :rows]
        ew = None if ew is None else ew[r, :rows]
    else:
        nbr, mask = pg.nbr, pg.nbr_mask
    n = nbr.shape[0]
    table = GraphBatch(
        nbr=torch.from_numpy(np.ascontiguousarray(nbr))[None],
        nbr_mask=torch.from_numpy(np.ascontiguousarray(mask))[None],
        node_mask=torch.zeros((1, n), dtype=torch.float32),
        feats=torch.zeros((1, n, 1), dtype=torch.float32),
        labels=None,
        n_nodes=torch.zeros((1,), dtype=torch.int32),
        edge_weight=(None if ew is None
                     else torch.from_numpy(np.ascontiguousarray(ew))[None]),
        rslot=torch.from_numpy(reciprocal_slots(nbr[None], mask[None])),
    ).to(mesh.device)
    dev = mesh.device
    return RankGraph(
        feats=torch.from_numpy(np.ascontiguousarray(pg.feats[r])).to(dev),
        node_mask=torch.from_numpy(np.ascontiguousarray(pg.node_mask[r])).to(dev),
        labels=(None if pg.labels is None else
                torch.from_numpy(np.ascontiguousarray(pg.labels[r])).to(dev)),
        table=table)


# ---------------------------------------------------------------------------
# halo models: exchange-and-slice wrappers around the single-device layers
# ---------------------------------------------------------------------------


class _HaloBase(nn.Module):
    """`base` is the single-device model whose parameters (and checkpoints)
    the halo model shares."""

    dropout_per_rank = False   # p2p: dropout generators keyed on the rank

    def __init__(self, base: GraphSage | GAT, mesh: Mesh):
        super().__init__()
        self.base = base
        self.mesh = mesh

    def jax_parameters(self):
        return self.base.jax_parameters()

    def loss(self, rg: RankGraph, class_weights: torch.Tensor,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The global weighted cross-entropy over every rank's own rows, the
        same scalar on every rank."""
        logits = self(rg, train=train, generator=generator)
        wnll, w = weighted_nll_terms(logits, rg.labels, class_weights,
                                     rg.node_mask)
        num_den = all_reduce_sum(torch.stack([wnll.sum(), w.sum()]), self.mesh)
        return num_den[0] / num_den[1].clamp_min(1e-12)


class _HaloP2P(_HaloBase):
    """Per layer: exchange 2*W boundary rows, run the single-device conv on
    the extended rows, keep the own rows."""

    dropout_per_rank = True

    def __init__(self, base, mesh: Mesh, halo_width: int):
        super().__init__(base, mesh)
        self.halo_width = int(halo_width)

    def forward(self, rg: RankGraph, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> float32 logits [shard, C] of the rank's own rows."""
        W = self.halo_width
        h = rg.feats
        shard = h.shape[0]
        cd = compute_dtype()
        for i in range(self.base.num_layers):
            h = self._pre_exchange(h, i, train, generator)
            hc = h.to(cd)
            left, right = ring_exchange(hc, W, self.mesh)
            ext = torch.cat([left, hc, right], dim=0)
            out = self._conv(rg.table, ext[None], i, train, generator)[0]
            h = out[W:W + shard]
        return h.float()


class _HaloAllGather(_HaloBase):
    """Gather the inputs once, run the single-device model on the full
    table on every rank (one dropout mask on all of them), keep the own
    rows."""

    def forward(self, rg: RankGraph, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> float32 logits [shard, C] of the rank's own rows."""
        shard = rg.feats.shape[0]
        h_full = all_gather_rows(rg.feats, self.mesh)
        logits = self.base(rg.table, h=h_full[None], train=train,
                           generator=generator)[0]
        r = self.mesh.rank
        return logits[r * shard:(r + 1) * shard]


class _SageMixin:
    def _pre_exchange(self, h, i, train, generator):
        # feature dropout on all but the last layer, at the node's home rank
        # before the exchange, so every copy of a node sees one mask
        if train and i < self.base.num_layers - 1:
            h = _dropout(h, self.base.dropout, generator)
        return h

    def _conv(self, table, h, i, train, generator):
        last = i == self.base.num_layers - 1
        return self.base.layers[i](table, h, activation=not last)


class _GATMixin:
    def _pre_exchange(self, h, i, train, generator):
        # DGL's feat_drop on every layer; the residual reads the dropped
        # features too, so dropping at the home rank is the single-device math
        if train:
            h = _dropout(h, self.base.feat_drop, generator)
        return h

    def _conv(self, table, h, i, train, generator):
        base = self.base
        last = i == base.num_layers - 1
        out = base.layers[i](table, h, activation=not last,
                             attn_drop=base.attn_drop if train else 0.0,
                             negative_slope=base.negative_slope,
                             generator=generator)
        B, N = out.shape[:2]
        return out.mean(dim=2) if last else out.reshape(B, N, -1)


class HaloGraphSage(_SageMixin, _HaloAllGather):
    """GraphSage over a partition_graph PartitionedGraph (all_gather)."""


class HaloGraphSageP2P(_SageMixin, _HaloP2P):
    """GraphSage over a partition_graph_p2p graph: per layer each rank
    exchanges 2*W boundary rows with its ring neighbours and runs the
    single-device conv (its kernels included) on the extended rows."""


class HaloGAT(_GATMixin, _HaloAllGather):
    """GAT over a partition_graph PartitionedGraph (all_gather)."""


class HaloGATP2P(_GATMixin, _HaloP2P):
    """GAT with the boundary-only exchange (the fused attention kernels run
    on the extended rows)."""


# ---------------------------------------------------------------------------
# exchange accounting
# ---------------------------------------------------------------------------


def exchange_widths(model) -> list[int]:
    """Per-layer width of the exchanged rows: each layer's input width (p2p
    exchanges every layer's input rows), for SAGE and GAT alike."""
    base = getattr(model, "base", model)
    if isinstance(base, GraphSage):
        return list(base.dims[:-1])
    if isinstance(base, GAT):
        return [fi for (fi, _, _, _) in base.specs]
    raise TypeError(f"unknown halo model {type(model)!r}")


def exchange_bytes_per_step(model, pg: PartitionedGraph, variant: str,
                            halo_width: int | None = None,
                            dtype_bytes: int = 4) -> dict:
    """Analytic bytes each rank sends (and receives) per optimizer step,
    forward and backward (JAX halo.py:661). all_gather: one exchange of the
    input features, (S - 1) shards of them, and the same volume back in the
    backward. p2p: 2*W rows per layer each way, doubled for the backward.
    dtype_bytes=2 for fast mode's bf16 exchanges."""
    widths = exchange_widths(model)
    s, n_shard = pg.n_parts, pg.shard_size
    if variant == "all_gather":
        widths = widths[:1]
        rows = (s - 1) * n_shard
    elif variant == "p2p":
        if halo_width is None:
            raise ValueError("p2p accounting needs halo_width")
        rows = 2 * halo_width
    else:
        raise ValueError(variant)
    fwd = sum(w * rows * dtype_bytes for w in widths)
    return {
        "variant": variant,
        "n_parts": s,
        "shard_rows": n_shard,
        "rows_exchanged_per_layer": rows,
        "layer_widths": widths,
        "fwd_bytes_per_device": fwd,
        "step_bytes_per_device": 2 * fwd,
    }
