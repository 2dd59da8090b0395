"""Plain GNN forward passes on COO edges, found by the configuration's
model: each model's own is `forward` of benchmark/models/<model>.py
(GraphSAGE with the pool aggregator, GAT), as the published models define
them.

Edges are (src -> dst) pairs over a union of graphs; a node's messages
come from its in-edges, and `graph` gives each node's graph index (int64
[N]; zeros for one graph), for a model with a term per graph. Weights are
the dict of benchmark/weights.py. Every step is a torch operation that
autograd differentiates, so the same code gives the reference's
gradients. `prec` (reference/precision.py) sets the dtype and where values
are rounded for a control.
"""

from __future__ import annotations

import torch

from .precision import Precision


def scatter_max(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """max over each node's in-edges of msg [E, ...] (>= 0), 0 where none."""
    idx = dst.view(-1, *([1] * (msg.dim() - 1))).expand_as(msg)
    out = torch.zeros((n, *msg.shape[1:]), dtype=msg.dtype, device=msg.device)
    return out.scatter_reduce(0, idx, msg, "amax", include_self=True)


def scatter_sum(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *msg.shape[1:]), dtype=msg.dtype, device=msg.device)
    return out.index_add(0, dst, msg)


def forward(config: dict, w: dict, feats, src, dst, graph, prec: Precision):
    """The configuration's model on a union of graphs: node logits [N, C]."""
    from ..models import load

    return load(config["model"]).forward(config, w, feats, src, dst, graph, prec)
