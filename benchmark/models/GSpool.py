"""GraphSAGE with the pool aggregator (the port's `GSpool`), as the
published model defines it:

  out_v = h_v W_self + max_{u->v} relu(h_u W_pool + b_pool) W_neigh + b

ReLU on every layer but the last; an empty neighbourhood's max is 0. The
graph index is not read: every term is a node's or an edge's.
"""

from __future__ import annotations

import torch

from ..reference.gnn import scatter_max
from ..reference.precision import Precision
from ..weights import GNN_BIAS_BOUND, xavier

KERNELS = ("max_agg_kernel", "max_agg_bwd_kernel")


def _dims(config: dict) -> list[int]:
    return [config["in_feats"], *config["layer_sizes"], config["out_classes"]]


def sage_specs(dims: list[int]) -> list[tuple[str, tuple, float]]:
    """GraphSAGE-pool: per layer b_pool, bias, w_neigh, w_pool, w_self."""
    specs = []
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        specs += [(f"l{i}.b_pool", (fi,), GNN_BIAS_BOUND),
                  (f"l{i}.bias", (fo,), GNN_BIAS_BOUND),
                  (f"l{i}.w_neigh", (fi, fo), xavier(fi, fo)),
                  (f"l{i}.w_pool", (fi, fi), xavier(fi, fi)),
                  (f"l{i}.w_self", (fi, fo), xavier(fi, fo))]
    return specs


def specs(config: dict) -> list[tuple[str, tuple, float]]:
    return sage_specs(_dims(config))


def sage_pool(w: dict, feats: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, n_layers: int, prec: Precision) -> torch.Tensor:
    """Node logits [N, C] of a GraphSAGE-pool stack."""
    n = feats.shape[0]
    h = feats.to(prec.dtype)

    r = prec.round

    def p(name):
        return r(w[name].to(prec.dtype))

    with prec.math():
        for i in range(n_layers):
            h = r(h)
            pooled = r(torch.relu(r(r(h @ p(f"l{i}.w_pool")) + p(f"l{i}.b_pool"))))
            mx = r(scatter_max(pooled[src], dst, n))
            h = r(r(r(h @ p(f"l{i}.w_self")) + r(mx @ p(f"l{i}.w_neigh")))
                  + p(f"l{i}.bias"))
            if i < n_layers - 1:
                h = torch.relu(h)
    return h


def forward(config: dict, w: dict, feats, src, dst, graph, prec: Precision):
    return sage_pool(w, feats, src, dst, len(config["layer_sizes"]) + 1, prec)


def sage_pool_layer(n: int, e: int, fi: int, fo: int) -> float:
    return 2.0 * n * fi * fi + 4.0 * n * fi * fo + 1.0 * e * fi


def layer_flops(config: dict, n: int, e: int) -> list[float]:
    dims = _dims(config)
    return [sage_pool_layer(n, e, a, b) for a, b in zip(dims[:-1], dims[1:])]
