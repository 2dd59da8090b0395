"""GraphSAGE with the pool aggregator (counterpart of gnn_tumor_seg_tpu/models/sage.py).

  pool: out_v = W_self h_v + W_neigh max_{u in N(v)} relu(W_pool h_u + b_pool) + bias

ReLU and feature dropout on every layer but the last (`model/networks.py:20-36`).
Weights keep the JAX package's [in, out] layout, so `h @ W` reads the same in
both and checkpoints cross without a transpose. The dense products stay
`torch.matmul`, as the JAX package leaves them to XLA; the max over
neighbours is the Hopper kernel on the card (ops/aggregate.py). The mean and
gcn aggregators wait for the port of gather_agg._sum_kernel (ROADMAP.md).

Under precision mode "fast" the layers run in bf16: activations and the
per-use parameter casts are bf16, the master parameters stay float32, and
the logits are cast back to float32 at the head.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.aggregate import aggregate_neighbors
from ..ops.graph import GraphBatch
from ..ops.precision import compute_dtype
from .initializers import xavier_uniform

__all__ = ["SageConv", "GraphSage"]


def _dropout(h, rate: float, generator: torch.Generator | None):
    if rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


class SageConv(nn.Module):
    """One SAGEConv-pool layer: h [B, N, F_in] -> [B, N, F_out]."""

    def __init__(self, in_feats: int, out_feats: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w_neigh = nn.Parameter(xavier_uniform((in_feats, out_feats), generator))
        self.w_self = nn.Parameter(xavier_uniform((in_feats, out_feats), generator))
        self.w_pool = nn.Parameter(xavier_uniform((in_feats, in_feats), generator))
        self.b_pool = nn.Parameter(torch.zeros(in_feats))
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, graph: GraphBatch, h: torch.Tensor, activation: bool,
                feat_drop: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cd = compute_dtype()
        h = _dropout(h, feat_drop, generator).to(cd)
        w_self, w_neigh, w_pool, b_pool, bias = (
            p.to(cd) for p in (self.w_self, self.w_neigh, self.w_pool,
                               self.b_pool, self.bias))
        p = torch.relu(h @ w_pool + b_pool)
        mx = aggregate_neighbors(p, graph.nbr, graph.nbr_mask, "max")
        out = h @ w_self + mx @ w_neigh
        out = out + bias
        return torch.relu(out) if activation else out


class GraphSage(nn.Module):
    """Input + hidden + output SAGEConv stack (`model/networks.py:20-36`):
    layer_sizes are the widths after the input and hidden layers; one extra
    output layer maps to n_classes."""

    def __init__(self, in_feats: int, layer_sizes: Sequence[int],
                 n_classes: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout = float(dropout)
        self.dims = [in_feats, *layer_sizes, n_classes]
        self.layers = nn.ModuleList(
            SageConv(self.dims[i], self.dims[i + 1], generator)
            for i in range(len(self.dims) - 1))

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def forward(self, graph: GraphBatch, h: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> float32 logits [B, N, n_classes]. Feature dropout applies only
        with train=True; `generator` (on the graph's device) draws it."""
        h = graph.feats if h is None else h
        for i, layer in enumerate(self.layers):
            last = i == self.num_layers - 1
            h = layer(graph, h, activation=not last,
                      feat_drop=0.0 if (last or not train) else self.dropout,
                      generator=generator)
        return h.float()
