"""GraphSAGE with the pool, mean and gcn aggregators (counterpart of
gnn_tumor_seg_tpu/models/sage.py).

  mean: out_v = W_self h_v + W_neigh mean_{u in N(v)} h_u + bias
  gcn:  out_v = W_neigh (sum_{u in N(v)} h_u + h_v) / (deg_in(v) + 1) + bias
  pool: out_v = W_self h_v + W_neigh max_{u in N(v)} relu(W_pool h_u + b_pool) + bias

ReLU and feature dropout on every layer but the last (`model/networks.py:20-36`).
Weights keep the JAX package's [in, out] layout, so `h @ W` reads the same in
both and checkpoints cross without a transpose. The dense products stay
`torch.matmul`, as the JAX package leaves them to XLA; the aggregation over
neighbours is a Hopper kernel on the card (ops/aggregate.py): max for pool,
sum and mean for gcn and mean, each with its backward kernel for training.
On a weighted graph (GraphBatch.edge_weight) mean becomes a weighted average
and gcn's sum and degree become weighted, as in the JAX package; both then
run the weighted-combine kernel, whose gradient reads the graph's `rslot`.

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

__all__ = ["SageConv", "GraphSage", "AGGREGATORS", "LAYER_KEYS"]

AGGREGATORS = ("mean", "gcn", "pool")
# each aggregator's parameters in the JAX package's pytree flatten order
# (dict keys sorted), which checkpoints and convert.py follow
LAYER_KEYS = {
    "pool": ("b_pool", "bias", "w_neigh", "w_pool", "w_self"),
    "mean": ("bias", "w_neigh", "w_self"),
    "gcn": ("bias", "w_neigh"),
}


def _dropout(h, rate: float, generator: torch.Generator | None):
    if rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


class SageConv(nn.Module):
    """One SAGEConv layer: h [B, N, F_in] -> [B, N, F_out]."""

    def __init__(self, in_feats: int, out_feats: int, aggregator: str = "pool",
                 generator: torch.Generator | None = None):
        super().__init__()
        if aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}; expected "
                             f"{AGGREGATORS}")
        self.aggregator = aggregator
        self.w_neigh = nn.Parameter(xavier_uniform((in_feats, out_feats), generator))
        if aggregator != "gcn":
            self.w_self = nn.Parameter(xavier_uniform((in_feats, out_feats),
                                                      generator))
        if aggregator == "pool":
            self.w_pool = nn.Parameter(xavier_uniform((in_feats, in_feats),
                                                      generator))
            self.b_pool = nn.Parameter(torch.zeros(in_feats))
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, graph: GraphBatch, h: torch.Tensor, activation: bool,
                feat_drop: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cd = compute_dtype()
        h = _dropout(h, feat_drop, generator).to(cd)
        p = {k: getattr(self, k).to(cd) for k in LAYER_KEYS[self.aggregator]}
        ew = graph.edge_weight
        if self.aggregator == "mean":
            h_n = aggregate_neighbors(h, graph.nbr, graph.nbr_mask, "mean",
                                      rslot=graph.rslot, edge_weight=ew)
            out = h @ p["w_self"] + h_n @ p["w_neigh"]
        elif self.aggregator == "gcn":
            s = aggregate_neighbors(h, graph.nbr, graph.nbr_mask, "sum",
                                    rslot=graph.rslot, edge_weight=ew)
            w_mask = graph.nbr_mask if ew is None else graph.nbr_mask * ew
            deg = w_mask.sum(dim=-1, keepdim=True)
            h_n = (s + h) / (deg + 1.0).to(s.dtype)
            out = h_n @ p["w_neigh"]
        else:
            pooled = torch.relu(h @ p["w_pool"] + p["b_pool"])
            mx = aggregate_neighbors(pooled, graph.nbr, graph.nbr_mask, "max",
                                     rslot=graph.rslot)
            out = h @ p["w_self"] + mx @ p["w_neigh"]
        out = out + p["bias"]
        return torch.relu(out) if activation else out


class GraphSage(nn.Module):
    """Input + hidden + output SAGEConv stack (`model/networks.py:20-36`):
    layer_sizes are the widths after the input and hidden layers; one extra
    output layer maps to n_classes."""

    def __init__(self, in_feats: int, layer_sizes: Sequence[int],
                 n_classes: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None,
                 aggregator: str = "pool"):
        super().__init__()
        self.aggregator = aggregator
        self.dropout = float(dropout)
        self.dims = [in_feats, *layer_sizes, n_classes]
        self.layers = nn.ModuleList(
            SageConv(self.dims[i], self.dims[i + 1], aggregator, generator)
            for i in range(len(self.dims) - 1))

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def jax_parameters(self) -> list[nn.Parameter]:
        """The parameters in the JAX package's pytree flatten order (layer,
        then LAYER_KEYS): the order of checkpoint leaves and of optimizer
        state leaves."""
        keys = LAYER_KEYS[self.aggregator]
        return [getattr(layer, k) for layer in self.layers for k in keys]

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
