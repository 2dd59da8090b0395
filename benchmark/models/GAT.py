"""GAT (the port's `GAT`, heads and residuals from the configuration), as
the published model defines it:

  z = h W (per head), e_{u->v} = LeakyReLU_0.2(a_l.z_u + a_r.z_v),
  alpha = softmax of e over v's in-edges,
  out_v = sum_u alpha z_u + residual + b, ELU on every layer but the last,
  which has one head (heads averaged)

The graph index is not read: the softmax runs over a node's in-edges.
"""

from __future__ import annotations

import torch

from ..reference.gnn import scatter_sum
from ..reference.precision import Precision
from ..weights import GNN_BIAS_BOUND, xavier

# the fused attention, and under attention dropout the decomposed path
KERNELS = ("gat_fwd_kernel", "gat_bwd_kernel", "gat_rev_kernel", "wsum_kernel",
           "pairdot_kernel", "slot_gather_kernel", "slot_gather_bwd_kernel")


def gat_layers(in_feats: int, layer_sizes, heads, residuals,
               out_classes: int) -> list[tuple[int, int, int, bool]]:
    """(in, out, heads, residual) of each GAT layer: the input layer has no
    residual, a hidden layer reads the previous width times its heads, the
    output layer has one head."""
    layers = [(in_feats, layer_sizes[0], heads[0], False)]
    for i in range(1, len(layer_sizes)):
        layers.append((layer_sizes[i - 1] * heads[i - 1], layer_sizes[i],
                       heads[i], bool(residuals[i])))
    layers.append((layer_sizes[-1] * heads[len(layer_sizes) - 1], out_classes,
                   1, False))
    return layers


def _layers(config: dict):
    return gat_layers(config["in_feats"], config["layer_sizes"],
                      config["gat_heads"], config["gat_residuals"],
                      config["out_classes"])


def gat_specs(layers) -> list[tuple[str, tuple, float]]:
    """GAT: per layer attn_l, attn_r, bias, w and, on a residual layer whose
    input width is not heads x out, w_res."""
    specs = []
    for i, (fi, fo, h, res) in enumerate(layers):
        hf = h * fo
        specs += [(f"l{i}.attn_l", (h, fo), xavier(h, fo)),
                  (f"l{i}.attn_r", (h, fo), xavier(h, fo)),
                  (f"l{i}.bias", (hf,), GNN_BIAS_BOUND),
                  (f"l{i}.w", (fi, hf), xavier(fi, hf))]
        if res and fi != hf:
            specs.append((f"l{i}.w_res", (fi, hf), xavier(fi, hf)))
    return specs


def specs(config: dict) -> list[tuple[str, tuple, float]]:
    return gat_specs(_layers(config))


def gat(w: dict, layers, feats: torch.Tensor, src: torch.Tensor,
        dst: torch.Tensor, prec: Precision, slope: float = 0.2) -> torch.Tensor:
    """Node logits [N, C] of a GAT stack; `layers` is gat_layers'."""
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
            alpha = a / scatter_sum(a, dst, n)[dst]
            out = scatter_sum(alpha[..., None] * z[src], dst, n)
            if res:
                r = prec.round(h @ p(f"l{i}.w_res")) if f"l{i}.w_res" in w else h
                out = out + r.view(n, heads, fo)
            out = out + p(f"l{i}.bias").view(heads, fo)
            h = (prec.round(out).mean(1) if last
                 else prec.round(torch.nn.functional.elu(out)).reshape(n, -1))
    return h


def forward(config: dict, w: dict, feats, src, dst, graph, prec: Precision):
    return gat(w, _layers(config), feats, src, dst, prec)


def gat_layer(n: int, e: int, fi: int, fo: int, heads: int, w_res: bool) -> float:
    hf = heads * fo
    dense = 2.0 * n * fi * hf * (2 if w_res else 1) + 4.0 * n * hf
    # per edge and head: score, LeakyReLU, exp, normalize; weighted sum of z
    return dense + 4.0 * e * heads + 2.0 * e * hf


def layer_flops(config: dict, n: int, e: int) -> list[float]:
    return [gat_layer(n, e, fi, fo, h, res and fi != h * fo)
            for fi, fo, h, res in _layers(config)]
