"""GraphGPS (Rampášek et al., "Recipe for a General, Powerful, Scalable
Graph Transformer", NeurIPS 2022; github.com/rampasek/GraphGPS) with its
`CustomGatedGCN+Transformer` layer, over the port's padded slot table.

The batch is the GraphBatch layout: node states h [B, N, W], and edge
states e [B, N, D, W] on the slots, slot (v, d) holding the edge
nbr[v, d] -> v (so i = v is the edge's destination and j = nbr[v, d] its
source). One layer (GraphGPS's GPSLayer around its GatedGCNLayer, Bresson
and Laurent 2017):

  ê_ij = D h_i + E h_j + C e_ij ;  σ_ij = sigmoid(ê_ij)
  x_i  = A h_i + Σ_j σ_ij ⊙ B h_j / (Σ_j σ_ij + 1e-6)
  h_M  = BN_local(h + ReLU(BN_x(x))) ;  e' = e + ReLU(BN_e(ê))
  h_T  = BN_attn(h + MHA(h))        (every real node of the node's graph)
  s    = h_M + h_T ;  h' = BN_ff(s + W2 ReLU(W1 s))

A..E are Linear W -> W with bias, MHA is torch.nn.MultiheadAttention's
arithmetic (one in-projection to q | k | v, heads of W / H columns, an
out-projection), W1 is W -> 2W. The node encoder is a Linear of the input
features, the edge encoder a Linear of |x_j - x_i| of the two ends' input
features. The head is GraphGym's MLP with batch norm: (Linear without
bias, BN, ReLU) x (post_layers - 1), then a Linear to the classes.
The last layer's edge update e' is never read, so that layer computes
none and has no BN_e (GraphGPS keeps its parameters, which never receive
a gradient). Dropout (the configuration's feature_dropout) acts at
GraphGPS's sites: after the GatedGCN's activations, after the local and
attention blocks, and in the FFN.

Parameters are [in, out] matrices (h @ w) and vectors, in the order of
`leaf_names` (the checkpoint's leaves, and the benchmark's weight specs):
the encoders, then per layer the GatedGCN (w_adbe, the columns of
A | D | B | E side by side, and their biases b_a, b_d, b_b, b_e, each a
leaf of its own; w_c, b_c; BN_x; BN_e but on the last layer), BN_local,
the attention (w_qkv, the columns of q | k | v, and the biases b_q, b_k,
b_v; w_o, b_o), BN_attn, the FFN (w_ff1, b_ff1, w_ff2, b_ff2), BN_ff,
then the head. The biases b_a, b_o and b_ff2 feed a BatchNorm straight
away, which subtracts them again, and b_k adds one score to every key of
a query, which the softmax subtracts: their gradient is 0 but for
rounding, as in GraphGPS, so each is a leaf of its own.

Every BatchNorm is masked: its statistics are over the batch's real nodes
(or real edge slots) only, in float32, and padded node rows come out 0, so
that padding moves nothing. Padded edge slots carry values no real slot
reads: each layer masks ê (the gate's and BN_e's input) once, and the
edge encoder's output is masked. Training (train=True) normalizes by the batch's
statistics and updates the running ones (momentum 0.1, the unbiased
variance, as torch.nn.BatchNorm1d); evaluation and serving read the
running ones, torch buffers registered in leaf order, which the checkpoint
carries as its buffer leaves.
The scale is stored as its offset from 1 (the parameter g, scale 1 + g),
so that g = 0 is torch's initial scale.

The message passing reads each slot's neighbour rows through the slot
gather of ops/kernels/slot_gather.py: B h_j and E h_j (a gather each, so
that both edge tensors are contiguous; the gradient through the graph's
`rslot`), and the input features for the edge encoder.

The attention reads the projection qkv [B, N, 3W] (q | k | v, heads of
W / H columns) and gives att [B, N, W], the layout `@ w_o` takes. In "fast"
(bfloat16) it is the port's varlen kernels (ops/kernels/graph_attn.py; the
plain version on a CPU tensor): each graph's real-node count, a device
int32 [B] that the forward computes once from node_mask (whose real rows are
a prefix), bounds the key and query loops, padded rows of att and of its
gradient are 0, and a graph with no real node gives zeros; the step's CUDA
graph replays them for any batch. In "exact" (float32) it is torch's
scaled_dot_product_attention on its memory-efficient backend over [B, H, N,
P], the head width padded to P, the next multiple of 8 above W / H, with one
channel masking the padded keys (`_sdpa_attention`); its padded query rows
carry values that the next BatchNorm zeroes.

Under precision mode "fast" activations and the per-use parameter casts
are bf16, the master parameters float32, the BatchNorm arithmetic float32
and the logits float32; "exact" is float32 throughout.

Spans (spans.py) `gps.local`, `gps.attn` and `gps.ffn` time each layer's
three blocks into `host_s` (eager steps; a captured step records them
once) and under a profiler open their record_function copies.
`step_counts` gives the trainer the step's attention pairs: those the
varlen forward visits in "fast", every padded pair in "exact".
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch import nn

from .. import spans
from ..ops.graph import GraphBatch
from ..ops.kernels import graph_attn, slot_gather
from ..ops.precision import compute_dtype
from .sage import _dropout

__all__ = ["GPS", "GPSLayer", "MaskedBatchNorm"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
GATE_EPS = 1e-6
# the score offset of a padded key, before the softmax scale
_PAD_KEY = -1e4


def _uniform(shape, bound: float, generator: torch.Generator | None):
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


def _linear(module: nn.Module, name: str, fan_in: int, fan_out: int,
            generator, bias: bool = True, w_bound: float | None = None,
            b_bound: float | None = None) -> None:
    """Register w_<name> [fan_in, fan_out] and b_<name> [fan_out], drawn as
    torch.nn.Linear draws them (uniform within 1/sqrt(fan_in)) unless
    bounds are given (0 for a bias torch initializes to zero)."""
    lim = 1.0 / math.sqrt(fan_in)
    w_bound = lim if w_bound is None else w_bound
    setattr(module, f"w_{name}",
            nn.Parameter(_uniform((fan_in, fan_out), w_bound, generator)))
    if bias:
        b_bound = lim if b_bound is None else b_bound
        setattr(module, f"b_{name}",
                nn.Parameter(_uniform((fan_out,), b_bound, generator)))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the real rows of a padded tensor (module doc): the
    scale offset g and the shift b, and the running statistics."""

    def __init__(self, width: int):
        super().__init__()
        self.g = nn.Parameter(torch.zeros(width))
        self.b = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None,
                count: torch.Tensor, train: bool) -> torch.Tensor:
        """x [..., W] normalized over its `count` real rows (a device
        scalar), in x's dtype: those where mask [...] is 1, padded rows
        coming out 0. With mask None the caller's x is already 0 on the
        padded rows and the output's padded rows are left as they come
        (the shift): two passes fewer over an edge tensor, for a caller
        that masks where it reads. With train the batch's statistics are
        used and the running ones updated; without, the running ones.

        The statistics are float32 sums over x's own dtype (sum and sum of
        squares of the real rows: two reads, no float32 copy), the scale a
        and shift c float32 vectors cast to x's dtype, and the output one
        x * a + c over x: a few passes over an edge tensor rather than a
        float32 pass per operation."""
        m = None if mask is None else mask[..., None].to(x.dtype)
        if train:
            dims = tuple(range(x.dim() - 1))
            if m is not None:
                x = x * m
            mean = x.sum(dims, dtype=torch.float32) / count
            var = (x.square().sum(dims, dtype=torch.float32) / count
                   - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * (count / (count - 1.0).clamp_min(1.0))
                self.running_mean.lerp_(mean, BN_MOMENTUM)
                self.running_var.lerp_(unbiased, BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + BN_EPS) * (1.0 + self.g)
        c = self.b - mean * a
        y = torch.addcmul(c.to(x.dtype), x, a.to(x.dtype))
        return y if m is None else y * m


def _sdpa_backends(device: torch.device):
    """The backend the SDPA path may take: on the card the memory-efficient
    one (float32), never the math path that materializes every score; on
    the CPU torch's choice."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])


def _sdpa_attention(qkv: torch.Tensor, heads: int,
                    node_mask: torch.Tensor) -> torch.Tensor:
    """The "exact" attention (module doc): torch's scaled_dot_product_attention
    with the key-mask channel. q holds 1 there, k 0 on a real node and -1e4
    on a padded one, so a padded key's score sits thousands below every real
    one and its weight underflows to exactly 0; the other pad channels are
    0, so the product over real nodes is exact."""
    B, N, C = qkv.shape
    q, k, v = qkv.view(B, N, 3, heads, C // (3 * heads)).unbind(2)
    F = q.shape[-1]
    P = (F // 8 + 1) * 8        # a multiple of 8 with a channel for the mask
    new = q.new_zeros
    one = q.new_ones((B, N, heads, 1))
    key_bias = ((1.0 - node_mask) * _PAD_KEY).to(q.dtype)[:, :, None, None]
    rest = new((B, N, heads, P - F - 1))
    qp = torch.cat([q, one, rest], -1).transpose(1, 2)
    kp = torch.cat([k, key_bias.expand(B, N, heads, 1), rest], -1).transpose(1, 2)
    vp = torch.cat([v, new((B, N, heads, P - F))], -1).transpose(1, 2)
    with _sdpa_backends(q.device):
        out = torch.nn.functional.scaled_dot_product_attention(
            qp, kp, vp, scale=1.0 / math.sqrt(F))
    return out.transpose(1, 2)[..., :F].reshape(B, N, heads * F)


def graph_attention(qkv: torch.Tensor, heads: int, node_mask: torch.Tensor,
                    n_real: torch.Tensor) -> torch.Tensor:
    """Multi-head attention of each graph's nodes over its real nodes: qkv
    [B, N, 3W] -> att [B, N, W] (module doc). bfloat16 takes the varlen
    kernels, bounded by n_real (int32 [B], each graph's real nodes); float32
    the SDPA path, bounded by node_mask."""
    if qkv.dtype == torch.bfloat16:
        return graph_attn.attention(qkv, n_real, heads)
    return _sdpa_attention(qkv, heads, node_mask)


class GPSLayer(nn.Module):
    """One GPS layer (module doc): h [B, N, W], e [B, N, D, W] -> h', e'
    (e' None where `edge_out` is False: the last layer's)."""

    def __init__(self, width: int, heads: int, edge_out: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if width % heads:
            raise ValueError(f"{heads} heads do not divide the width {width}")
        self.width, self.heads, self.edge_out = width, heads, edge_out
        self.keys = (("w_adbe", "b_a", "b_d", "b_b", "b_e", "w_c", "b_c", "bn_x")
                     + (("bn_e",) if edge_out else ())
                     + ("bn_local", "w_qkv", "b_q", "b_k", "b_v", "w_o", "b_o",
                        "bn_attn",
                        "w_ff1", "b_ff1", "w_ff2", "b_ff2", "bn_ff"))
        _linear(self, "adbe", width, 4 * width, generator, bias=False)
        for k in ("a", "d", "b", "e"):     # torch.nn.Linear's bias bound
            setattr(self, f"b_{k}", nn.Parameter(
                _uniform((width,), 1.0 / math.sqrt(width), generator)))
        _linear(self, "c", width, width, generator)
        self.bn_x = MaskedBatchNorm(width)
        if edge_out:
            self.bn_e = MaskedBatchNorm(width)
        self.bn_local = MaskedBatchNorm(width)
        # torch.nn.MultiheadAttention: Xavier in-projection, zero biases
        _linear(self, "qkv", width, 3 * width, generator,
                w_bound=math.sqrt(6.0 / (4 * width)), bias=False)
        for k in ("q", "k", "v"):
            setattr(self, f"b_{k}", nn.Parameter(torch.zeros(width)))
        _linear(self, "o", width, width, generator, b_bound=0.0)
        self.bn_attn = MaskedBatchNorm(width)
        _linear(self, "ff1", width, 2 * width, generator)
        _linear(self, "ff2", 2 * width, width, generator)
        self.bn_ff = MaskedBatchNorm(width)
        self.host_s: dict = {}

    def forward(self, graph: GraphBatch, h: torch.Tensor, e: torch.Tensor,
                counts, train: bool, dropout: float = 0.0,
                generator: torch.Generator | None = None):
        cd = h.dtype
        W = self.width
        nmask, emask = graph.node_mask, graph.nbr_mask
        n_nodes, n_edges, pad_slots, n_real = counts
        drop = dropout if train else 0.0

        def p(name):
            return getattr(self, name).to(cd)

        with spans.span("gps.local", self.host_s, "local"):
            adbe = h @ p("w_adbe")
            a = adbe[..., :W] + p("b_a")
            d = adbe[..., W:2 * W] + (p("b_d") + p("b_c"))  # C's bias with D's
            b_j, e_j = (slot_gather.gather_slots(adbe[..., k * W:(k + 1) * W]
                                                 + p(f"b_{c}"), graph.nbr, emask,
                                                 graph.rslot)
                        for k, c in ((2, "b"), (3, "e")))
            # ê = C e + E h_j + D h_i, added into the product and masked once:
            # 0 on padded slots, whose sigmoid 1/2 the denominator takes out
            # again (B h_j is 0 there, so the numerator needs nothing)
            e_hat = ((e @ p("w_c")).add_(e_j).add_(d[:, :, None, :])
                     .mul_(emask[..., None].to(cd)))
            sigma = torch.sigmoid(e_hat)
            den = sigma.sum(2, dtype=torch.float32) - 0.5 * pad_slots
            num = (sigma * b_j).sum(2, dtype=torch.float32)
            x = a + (num / (den + GATE_EPS)).to(cd)
            x = torch.relu(self.bn_x(x, nmask, n_nodes, train))
            h_local = h + _dropout(x, drop, generator)
            if self.edge_out:
                # ê is 0 on padded slots already; e's padded slots stay unread
                e_new = torch.relu(self.bn_e(e_hat, None, n_edges, train))
                e = e + _dropout(e_new, drop, generator)
            else:
                e = None
            h_local = self.bn_local(h_local, nmask, n_nodes, train)
        with spans.span("gps.attn", self.host_s, "attn"):
            b_qkv = torch.cat([p("b_q"), p("b_k"), p("b_v")])
            qkv = h @ p("w_qkv") + b_qkv
            att = (graph_attention(qkv, self.heads, nmask, n_real) @ p("w_o")
                   + p("b_o"))
            h_attn = self.bn_attn(h + _dropout(att, drop, generator), nmask,
                                  n_nodes, train)
        with spans.span("gps.ffn", self.host_s, "ffn"):
            s = h_local + h_attn
            f = _dropout(torch.relu(s @ p("w_ff1") + p("b_ff1")), drop, generator)
            f = _dropout(f @ p("w_ff2") + p("b_ff2"), drop, generator)
            h = self.bn_ff(s + f, nmask, n_nodes, train)
        return h, e


class GPS(nn.Module):
    """Encoders, len(layer_sizes) GPS layers of width layer_sizes[0] and
    `heads` heads, and the post-MP head of `post_layers` layers."""

    def __init__(self, in_feats: int, layer_sizes: Sequence[int], n_classes: int,
                 heads: int, post_layers: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        layer_sizes = list(layer_sizes)
        if not layer_sizes or len(set(layer_sizes)) != 1:
            raise ValueError(f"GPS layers share one width (residuals); got "
                             f"layer_sizes {layer_sizes}")
        if post_layers < 1:
            raise ValueError(f"post_layers must be at least 1, got {post_layers}")
        W = layer_sizes[0]
        self.width, self.heads, self.dropout = W, int(heads), float(dropout)
        enc = nn.Module()
        _linear(enc, "node", in_feats, W, generator)
        _linear(enc, "edge", in_feats, W, generator)
        enc.keys = ("w_node", "b_node", "w_edge", "b_edge")
        self.enc = enc
        L = len(layer_sizes)
        self.layers = nn.ModuleList(GPSLayer(W, self.heads, i < L - 1, generator)
                                    for i in range(L))
        self.post = nn.ModuleList()
        for j in range(post_layers):
            last = j == post_layers - 1
            m = nn.Module()
            _linear(m, "lin", W, n_classes if last else W, generator, bias=last)
            if not last:
                m.bn = MaskedBatchNorm(W)
            m.keys = ("w_lin", "b_lin") if last else ("w_lin", "bn")
            self.post.append(m)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def host_s(self) -> dict:
        """Seconds of the layers' gps.local, gps.attn and gps.ffn spans."""
        out: dict = {}
        for layer in self.layers:
            for k, v in layer.host_s.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _leaf_modules(self) -> list[tuple[str, nn.Module]]:
        """(name prefix, module) of the encoders, each layer and each head
        layer, in leaf order; each module's `keys` order its leaves."""
        return ([("enc", self.enc)]
                + [(f"l{i}", layer) for i, layer in enumerate(self.layers)]
                + [(f"post{j}", m) for j, m in enumerate(self.post)])

    def named_leaves(self) -> list[tuple[str, nn.Parameter]]:
        """(name, parameter) in the port's own leaf order: the order of
        checkpoint leaves, of optimizer state leaves and of the benchmark's
        weight specs; a BatchNorm gives its g and b."""
        out = []
        for prefix, module in self._leaf_modules():
            for k in module.keys:
                v = getattr(module, k)
                out += ([(f"{prefix}.{k}.g", v.g), (f"{prefix}.{k}.b", v.b)]
                        if isinstance(v, MaskedBatchNorm) else [(f"{prefix}.{k}", v)])
        return out

    def leaf_names(self) -> list[str]:
        return [name for name, _ in self.named_leaves()]

    def jax_parameters(self) -> list[nn.Parameter]:
        """named_leaves' parameters (GPS has no JAX counterpart; the name is
        the trainer's and checkpoint's protocol)."""
        return [p for _, p in self.named_leaves()]

    def step_counts(self, n_nodes: Sequence[int], n_pad: int) -> dict:
        """Counters of one step over graphs of `n_nodes` real nodes padded
        to n_pad, under the current precision: the query-key pairs the
        attention computes (attn_pairs: in "fast" those of the varlen
        forward's tiles, graph_attn.visited_pairs; in "exact" n_pad^2 a
        graph) and those between real nodes (attn_real_pairs), over every
        head of every layer."""
        per = self.heads * self.num_layers
        if compute_dtype() == torch.bfloat16:
            pairs = sum(graph_attn.visited_pairs(int(n)) for n in n_nodes)
        else:
            pairs = len(n_nodes) * n_pad * n_pad
        return {"attn_pairs": per * pairs,
                "attn_real_pairs": per * sum(int(n) * int(n) for n in n_nodes)}

    def forward(self, graph: GraphBatch, h: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> float32 logits [B, N, n_classes]. BatchNorm uses the batch's
        statistics and dropout acts only with train=True; `generator` (on
        the graph's device) draws the dropout."""
        cd = compute_dtype()
        feats = graph.feats if h is None else h
        nmask, emask = graph.node_mask, graph.nbr_mask
        # real nodes, real slots, each row's padded slots [B, N, 1], and
        # each graph's real nodes (int32 [B], the varlen attention's bound)
        counts = (nmask.sum(), emask.sum(),
                  (emask.shape[-1] - emask.sum(-1, keepdim=True)),
                  nmask.sum(1).to(torch.int32))
        x_j = slot_gather.slot_gather(feats.contiguous(), graph.nbr, emask)
        enc = self.enc
        h = feats.to(cd) @ enc.w_node.to(cd) + enc.b_node.to(cd)
        e = ((x_j - feats[:, :, None, :]).abs().to(cd) @ enc.w_edge.to(cd)
             + enc.b_edge.to(cd)) * emask[..., None].to(cd)
        for layer in self.layers:
            h, e = layer(graph, h, e, counts, train, self.dropout, generator)
        for m in self.post:
            h = h @ m.w_lin.to(cd)
            if hasattr(m, "b_lin"):
                h = h + m.b_lin.to(cd)
            else:
                h = _dropout(torch.relu(m.bn(h, nmask, counts[0], train)),
                             self.dropout if train else 0.0, generator)
        return h.float()
