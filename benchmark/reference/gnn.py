"""Plain GNN forward passes on COO edges: GraphSAGE with the pool
aggregator and GAT, as the published models define them.

  SAGE-pool: out_v = h_v W_self + max_{u->v} relu(h_u W_pool + b_pool) W_neigh + b
             (ReLU on every layer but the last; an empty neighbourhood's max is 0)
  GAT:       z = h W (per head), e_{u->v} = LeakyReLU_0.2(a_l.z_u + a_r.z_v),
             alpha = softmax of e over v's in-edges,
             out_v = sum_u alpha z_u + residual + b, ELU on every layer but the
             last, which has one head (heads averaged)

Edges are (src -> dst) pairs; a node's messages come from its in-edges.
Weights are the dict of benchmark/weights.py. Every step is a torch
operation that autograd differentiates, so the same code gives the
reference's gradients. `prec` (reference/precision.py) sets the dtype and
where values are rounded for a control.
"""

from __future__ import annotations

import torch

from .precision import Precision


def _scatter_max(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """max over each node's in-edges of msg [E, ...] (>= 0), 0 where none."""
    idx = dst.view(-1, *([1] * (msg.dim() - 1))).expand_as(msg)
    out = torch.zeros((n, *msg.shape[1:]), dtype=msg.dtype, device=msg.device)
    return out.scatter_reduce(0, idx, msg, "amax", include_self=True)


def _scatter_sum(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *msg.shape[1:]), dtype=msg.dtype, device=msg.device)
    return out.index_add(0, dst, msg)


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
            mx = r(_scatter_max(pooled[src], dst, n))
            h = r(r(r(h @ p(f"l{i}.w_self")) + r(mx @ p(f"l{i}.w_neigh")))
                  + p(f"l{i}.bias"))
            if i < n_layers - 1:
                h = torch.relu(h)
    return h


def gat(w: dict, layers, feats: torch.Tensor, src: torch.Tensor,
        dst: torch.Tensor, prec: Precision, slope: float = 0.2) -> torch.Tensor:
    """Node logits [N, C] of a GAT stack; `layers` is weights.gat_layers'."""
    n = feats.shape[0]
    h = feats.to(prec.dtype)

    def p(name):
        return prec.round(w[name].to(prec.dtype))

    with prec.math():
        for i, (fi, fo, heads, res) in enumerate(layers):
            last = i == len(layers) - 1
            h = prec.round(h)
            z = prec.round((h @ p(f"l{i}.w")).view(n, heads, fo))
            el = prec.round((z * p(f"l{i}.attn_l")).sum(-1))
            er = prec.round((z * p(f"l{i}.attn_r")).sum(-1))
            # softmax, weighted sum and epilogue: one fused step, rounded once
            e = torch.nn.functional.leaky_relu(el[src] + er[dst], slope)
            emax = torch.full((n, heads), -torch.inf, dtype=e.dtype, device=e.device)
            emax = emax.scatter_reduce(0, dst.view(-1, 1).expand_as(e), e.detach(),
                                       "amax", include_self=True)
            a = torch.exp(e - emax[dst])
            alpha = a / _scatter_sum(a, dst, n)[dst]
            out = _scatter_sum(alpha[..., None] * z[src], dst, n)
            if res:
                r = prec.round(h @ p(f"l{i}.w_res")) if f"l{i}.w_res" in w else h
                out = out + r.view(n, heads, fo)
            out = out + p(f"l{i}.bias").view(heads, fo)
            h = (prec.round(out).mean(1) if last
                 else prec.round(torch.nn.functional.elu(out)).reshape(n, -1))
    return h


def forward(config: dict, w: dict, feats, src, dst, prec: Precision):
    """The configuration's model on one graph (or a union of graphs)."""
    from ..weights import gat_layers

    if config["model"] == "GSpool":
        return sage_pool(w, feats, src, dst, len(config["layer_sizes"]) + 1, prec)
    if config["model"] == "GAT":
        layers = gat_layers(config["in_feats"], config["layer_sizes"],
                            config["gat_heads"], config["gat_residuals"],
                            config["out_classes"])
        return gat(w, layers, feats, src, dst, prec)
    raise ValueError(f"no reference for model {config['model']!r}")
