"""GraphGPS (Rampášek et al., NeurIPS 2022, github.com/rampasek/GraphGPS;
the port's `GPS`) as the published model defines it: GPSLayer with the
CustomGatedGCN local model and torch.nn.MultiheadAttention, GraphGym's
post-MP head. With i an edge's destination and j its source:

  ê_ij = D h_i + E h_j + C e_ij ;  σ_ij = sigmoid(ê_ij)
  x_i  = A h_i + Σ_j σ_ij ⊙ B h_j / (Σ_j σ_ij + 1e-6)
  h_M  = BN_local(h + ReLU(BN_x(x))) ;  e' = e + ReLU(BN_e(ê))
  h_T  = BN_attn(h + MHA(h))     (softmax over the nodes of the node's graph)
  s    = h_M + h_T ;  h' = BN_ff(s + W2 ReLU(W1 s))

Node encoder Linear(x), edge encoder Linear(|x_j - x_i|) of the input
features, head (Linear without bias, BN, ReLU) x (gps_post_layers - 1) and
a Linear to the classes. Every BatchNorm is in training mode over all the
union's nodes (or edges): batch statistics, biased variance, eps 1e-5; its
scale is 1 + g, g the stored weight (the port's parameterization). The
attention runs one graph at a time (`graph`) under activation
checkpointing, so that a 7 000-node graph's heads x 7 000^2 scores fit on
the card in float64 and are recomputed in the backward pass. No dropout:
the cells train without it.

The last layer's edge update is never read: it is not computed, and that
layer has no BN_e weights (GraphGPS keeps them; they get no gradient).

Departures from the published VOC-SP model (configs/gps-gatedgcn-4x96.json,
`reduced`): no LapPE positional encoding, attention dropout 0.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..reference.gnn import scatter_sum
from ..reference.precision import Precision
from ..weights import GNN_BIAS_BOUND

# the message passing's slot gather forward and backward (the attention is
# torch's scaled_dot_product_attention: not the port's own kernel)
KERNELS = ("slot_gather_kernel", "slot_gather_bwd_kernel")

BN_EPS = 1e-5
GATE_EPS = 1e-6
# BatchNorm scales 1 + g with g uniform within this bound: U(0.5, 1.5)
BN_SCALE_BOUND = 0.5
_BN = ("bn_x", "bn_e", "bn_local")


def dims(config: dict) -> tuple[int, int, int, int]:
    """(width, layers, heads, post layers) of a configuration."""
    sizes = config["layer_sizes"]
    if len(set(sizes)) != 1:
        raise ValueError(f"GPS layers share one width; got {sizes}")
    return sizes[0], len(sizes), config["gps_heads"], config["gps_post_layers"]


def _lin(prefix: str, key: str, fan_in: int, fan_out: int, w_bound=None,
         b_bound=None, bias: bool = True):
    """<prefix>.w_<key> [fan_in, fan_out] and <prefix>.b_<key>, within
    torch.nn.Linear's bounds unless others are given."""
    lim = 1.0 / math.sqrt(fan_in)
    out = [(f"{prefix}.w_{key}", (fan_in, fan_out),
            lim if w_bound is None else w_bound)]
    if bias:
        out.append((f"{prefix}.b_{key}", (fan_out,),
                    lim if b_bound is None else b_bound))
    return out


def _bn(name: str, width: int):
    return [(f"{name}.g", (width,), BN_SCALE_BOUND),
            (f"{name}.b", (width,), GNN_BIAS_BOUND)]


def specs(config: dict) -> list[tuple[str, tuple, float]]:
    """Weights in the port's leaf order (GPS.leaf_names), within the
    published initializers' bounds: torch.nn.Linear's 1/sqrt(fan_in),
    MultiheadAttention's Xavier in-projection; its zero biases within
    +-0.1, BatchNorm shifts within +-0.1 and scales 1 + U(-0.5, 0.5)
    (configuration's `assumed`)."""
    W, L, _, P = dims(config)
    F, C = config["in_feats"], config["out_classes"]
    out = _lin("enc", "node", F, W) + _lin("enc", "edge", F, W)
    for i in range(L):
        out += _lin(f"l{i}", "adbe", W, 4 * W, bias=False)
        out += [(f"l{i}.b_{k}", (W,), 1.0 / math.sqrt(W)) for k in "adbe"]
        out += _lin(f"l{i}", "c", W, W)
        for b in _BN if i < L - 1 else ("bn_x", "bn_local"):
            out += _bn(f"l{i}.{b}", W)
        out += _lin(f"l{i}", "qkv", W, 3 * W, w_bound=math.sqrt(6.0 / (4 * W)),
                    bias=False)
        out += [(f"l{i}.b_{k}", (W,), GNN_BIAS_BOUND) for k in "qkv"]
        out += _lin(f"l{i}", "o", W, W, b_bound=GNN_BIAS_BOUND)
        out += _bn(f"l{i}.bn_attn", W)
        out += _lin(f"l{i}", "ff1", W, 2 * W) + _lin(f"l{i}", "ff2", 2 * W, W)
        out += _bn(f"l{i}.bn_ff", W)
    for j in range(P - 1):
        out += _lin(f"post{j}", "lin", W, W, bias=False) + _bn(f"post{j}.bn", W)
    return out + _lin(f"post{P - 1}", "lin", W, C)


def _attend(q, k, v, scale: float):
    """Softmax attention of one graph: q, k, v [n, H, F] -> [n, H, F]."""
    s = torch.einsum("ihf,jhf->hij", q, k) * scale
    return torch.einsum("hij,jhf->ihf", torch.softmax(s, dim=-1), v)


def gps(config: dict, w: dict, feats, src, dst, graph, prec: Precision):
    W, L, H, P = dims(config)
    n = feats.shape[0]
    sizes = torch.bincount(graph).tolist()
    scale = 1.0 / math.sqrt(W // H)
    r = prec.round

    def p(name):                       # a matrix or bias, cast at use
        return r(w[name].to(prec.dtype))

    def linear(x, prefix, key):
        y = r(x @ p(f"{prefix}.w_{key}"))
        b = f"{prefix}.b_{key}"
        return r(y + p(b)) if b in w else y

    def bn(x, name):
        """Batch statistics; the scale a and shift c, rounded where the
        program casts them for use, applied as x a + c, rounded once."""
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        a = (1.0 + w[f"{name}.g"].to(prec.dtype)) / torch.sqrt(var + BN_EPS)
        c = w[f"{name}.b"].to(prec.dtype) - mean * a
        return r(x * r(a) + r(c))

    x = feats.to(prec.dtype)
    with prec.math():
        h = linear(r(x), "enc", "node")
        e = linear(r((x[src] - x[dst]).abs()), "enc", "edge")
        for i in range(L):
            pre = f"l{i}"
            adbe = linear(h, pre, "adbe")
            a, d, b, ee = (r(adbe[:, j * W:(j + 1) * W] + p(f"{pre}.b_{k}"))
                           for j, k in enumerate("adbe"))
            e_hat = r(r(d[dst] + ee[src]) + linear(e, pre, "c"))
            sigma = r(torch.sigmoid(e_hat))
            num = scatter_sum(r(sigma * b[src]), dst, n)   # float32 sums
            den = scatter_sum(sigma, dst, n)
            agg = r(a + r(num / (den + GATE_EPS)))
            h_local = bn(r(h + torch.relu(bn(agg, f"{pre}.bn_x"))), f"{pre}.bn_local")
            if i < L - 1:
                e = r(e + torch.relu(bn(e_hat, f"{pre}.bn_e")))
            b_qkv = torch.cat([p(f"{pre}.b_{k}") for k in "qkv"])
            qkv = r(linear(h, pre, "qkv") + b_qkv).view(n, 3, H, W // H)
            outs, start = [], 0
            for size in sizes:          # one graph at a time, recomputed
                q, k, v = (qkv[start:start + size, t] for t in range(3))
                outs.append(checkpoint(_attend, q, k, v, scale, use_reentrant=False))
                start += size
            att = linear(r(torch.cat(outs).reshape(n, W)), pre, "o")
            h_attn = bn(r(h + att), f"{pre}.bn_attn")
            s = r(h_local + h_attn)
            f = linear(r(torch.relu(linear(s, pre, "ff1"))), pre, "ff2")
            h = bn(r(s + f), f"{pre}.bn_ff")
        for j in range(P - 1):
            h = r(torch.relu(bn(linear(h, f"post{j}", "lin"), f"post{j}.bn")))
        return linear(h, f"post{P - 1}", "lin")


def forward(config: dict, w: dict, feats, src, dst, graph, prec: Precision):
    return gps(config, w, feats, src, dst, graph, prec)


def gps_layer(n: int, e: int, width: int) -> float:
    """Forward FLOPs of one GPS layer over a graph of n real nodes and e real
    (directed) edges: the GatedGCN's node products (A, B, D, E) and edge
    product (C), its gating (sum and weighted sum over each edge), the
    attention's projections and its 4 n^2 W on real pairs (scores and
    weighted sum over every head), and the FFN."""
    W = width
    gcn = 2.0 * n * W * 4 * W + 2.0 * e * W * W + 4.0 * e * W
    attn = 2.0 * n * W * 3 * W + 2.0 * n * W * W + 4.0 * n * n * W
    ffn = 2.0 * 2.0 * n * W * 2 * W
    return gcn + attn + ffn


def layer_flops(config: dict, n: int, e: int) -> list[float]:
    """[encoders, each GPS layer, head] over one graph of n nodes and e
    edges."""
    W, L, _, P = dims(config)
    F, C = config["in_feats"], config["out_classes"]
    enc = 2.0 * n * F * W + 2.0 * e * F * W
    head = 2.0 * n * W * W * (P - 1) + 2.0 * n * W * C
    return [enc] + [gps_layer(n, e, W)] * L + [head]
