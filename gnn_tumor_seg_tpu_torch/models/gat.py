"""Graph attention (GAT) over the ELL layout (counterpart of
gnn_tumor_seg_tpu/models/gat.py), the semantics of DGL's GATConv as the
reference's GAT stack uses it (`model/networks.py:39-66`):

  z_v      = W h_v                      (per-head projection, no bias)
  el_v     = a_l . z_v ; er_v = a_r . z_v
  e_{u->v} = LeakyReLU(el_u + er_v)     (negative_slope 0.2)
  alpha    = softmax over the in-edges of v
  out_v    = act(sum_u alpha_{u->v} z_u + residual + bias)

Parameters keep the JAX layout: w [in, H*F], attn_l and attn_r [H, F],
bias [H*F], and w_res [in, H*F] only on a layer with a residual whose input
width differs from H*F (otherwise the residual is the input itself). The
residual reads the dropped features, as DGL's GATConv does. Hidden layers
flatten their heads; the output layer (one head) averages them. The dense
products h @ w, h @ w_res and the el/er contractions stay torch
operations, as the JAX package leaves them to XLA; the attention, the
weighted combine and the epilogue are the fused Hopper kernels of
ops/kernels/fused_gat.py on every layer, for training and serving alike.

Attention dropout (attn_drop > 0 in training) needs alpha materialized: the
layer then takes the JAX package's decomposed path (gat.py:119-144). The
slot gather of ops/kernels/slot_gather.py fetches each slot's el; the
LeakyReLU, the masked slot softmax and the dropout are torch elementwise
operations, as the JAX package leaves them to XLA; the weighted combine of
ops/kernels/weighted_sum.py sums alpha z over the slots; the epilogue is
torch again. Training through it needs the graph's `rslot`. The factory
never sets attn_drop; set it on the model (GAT(..., attn_drop=p)).

Under precision mode "fast" the layers run in bf16: activations and the
per-use parameter casts are bf16, the master parameters stay float32, and
the logits are cast back to float32 at the head.

Tensor parallelism (parallel/dp.py sets `mesh` and `tp_heads` on a layer
whose heads divide over the model ranks): the layer runs head-parallel.
The rank holds H / M whole heads: the matching contiguous [H*F] column
block of w, w_res and bias (the columns are laid out head-major) and the
rows of attn_l and attn_r. The fused kernels run on those heads, and the
[B, N, H*F] output is all-gathered. The replicated input h goes through
copy_to_model, whose backward sums the model ranks' partial gradients
(parallel/collectives.py). Attention dropout draws its mask for all H
heads and keeps the rank's, so each rank's mask is its slice of one
device's and every rank's generator stays in step. A layer whose heads do
not divide runs replicated, the same on every model rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.graph import GraphBatch
from ..ops.kernels import fused_gat, slot_gather, weighted_sum
from ..ops.precision import compute_dtype
from ..runtime import first_cpu_exp
from .initializers import xavier_uniform
from .sage import _dropout

__all__ = ["GatConv", "GAT"]

_NEG_LARGE = -1e30


class GatConv(nn.Module):
    """One GATConv layer: h [B, N, in_feats] -> [B, N, num_heads, out_feats]."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 residual: bool, generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads, self.out_feats = num_heads, out_feats
        self.residual = bool(residual)
        hf = num_heads * out_feats
        self.w = nn.Parameter(xavier_uniform((in_feats, hf), generator))
        # attention vectors: fan_in = heads, fan_out = out_feats, as the JAX
        # package draws its [1, H, F] vectors (initializers.py:18-21)
        self.attn_l = nn.Parameter(xavier_uniform((num_heads, out_feats), generator))
        self.attn_r = nn.Parameter(xavier_uniform((num_heads, out_feats), generator))
        self.bias = nn.Parameter(torch.zeros(hf))
        self.register_parameter(
            "w_res", nn.Parameter(xavier_uniform((in_feats, hf), generator))
            if self.residual and in_feats != hf else None)
        # tensor parallelism (module doc): set by parallel/dp.shard_model
        self.mesh = None
        self.tp_heads = False

    @property
    def keys(self) -> tuple[str, ...]:
        """The layer's parameter names in the JAX pytree flatten order."""
        keys = ("attn_l", "attn_r", "bias", "w")
        return keys + ("w_res",) if self.w_res is not None else keys

    def forward(self, graph: GraphBatch, h: torch.Tensor, activation: bool,
                feat_drop: float = 0.0, attn_drop: float = 0.0,
                negative_slope: float = 0.2,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cd = compute_dtype()
        p = {k: getattr(self, k).to(cd) for k in self.keys}
        h = _dropout(h.to(cd), feat_drop, generator)
        B, N, _ = h.shape
        H, F = p["attn_l"].shape        # the rank's heads under tensor parallelism
        tp = self.mesh is not None and self.tp_heads
        if tp:
            from ..parallel.collectives import copy_to_model, gather_from_model

            h = copy_to_model(h, self.mesh)
        z = (h @ p["w"]).reshape(B, N, H, F)
        el = torch.einsum("bnhf,hf->bnh", z, p["attn_l"]).contiguous()
        er = torch.einsum("bnhf,hf->bnh", z, p["attn_r"]).contiguous()
        res = None
        if self.residual and self.w_res is not None:
            res = h @ p["w_res"]
        elif self.residual:             # identity: the rank's heads' columns
            res = (h.narrow(-1, self.mesh.model_rank * H * F, H * F).contiguous()
                   if tp else h)
        act = "elu" if activation else None
        if attn_drop > 0.0:
            heads = (self.mesh.model_rank * H, self.num_heads) if tp else None
            out = self._decomposed(graph, z, el, er, res, p["bias"], act,
                                   negative_slope, attn_drop, generator, heads)
        else:
            out = fused_gat.fused_gat_attention(
                z, el, er, p["bias"], graph.nbr, graph.nbr_mask, graph.rslot,
                negative_slope, act, res)
        if tp:
            out = gather_from_model(out.reshape(B, N, H * F), self.mesh)
            return out.reshape(B, N, self.num_heads, F)
        return out

    @staticmethod
    def _decomposed(graph, z, el, er, res, bias, act, slope, attn_drop,
                    generator, heads=None):
        """The JAX decomposed path with attention dropout (gat.py:119-159):
        the slot gather and the weighted combine are kernels on the card.
        heads = (first head, all heads) on a head-sharded layer: the mask is
        drawn for every head and the rank's heads sliced out of it."""
        B, N, H, F = z.shape
        nbr, mask = graph.nbr, graph.nbr_mask
        el_src = slot_gather.gather_slots(el, nbr, mask, graph.rslot)  # [B,N,D,H]
        valid = mask[..., None]
        e = torch.nn.functional.leaky_relu(el_src + er[:, :, None, :], slope)
        e = torch.where(valid > 0, e, _NEG_LARGE)
        e = e - e.amax(dim=2, keepdim=True).detach()
        first_cpu_exp()
        w = torch.exp(e) * valid.to(e.dtype)
        alpha = w / w.sum(dim=2, keepdim=True).clamp_min(1e-20)
        if heads is None:
            alpha = _dropout(alpha, attn_drop, generator)
        else:                           # every head's mask; the rank's kept
            alpha = _dropout(alpha, attn_drop, generator, cols=heads)
        out = weighted_sum.weighted_combine(z, alpha, nbr, mask, graph.rslot)
        if res is not None:
            out = out + res.reshape(B, N, H, F)
        out = out + bias.reshape(H, F)
        return torch.nn.functional.elu(out) if act == "elu" else out


class GAT(nn.Module):
    """Input + hidden + output GATConv stack (`model/networks.py:39-66`).

    heads and residuals are per-layer lists over layer_sizes; a hidden
    layer's input width is the previous width times its heads. ELU on every
    layer but the output layer, which has one head of n_classes features;
    the input layer never has a residual."""

    def __init__(self, in_feats: int, layer_sizes: Sequence[int], n_classes: int,
                 heads: Sequence[int], residuals: Sequence[bool],
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        layer_sizes, heads = list(layer_sizes), list(heads)
        if len(heads) < len(layer_sizes) or len(residuals) < len(layer_sizes):
            raise ValueError(f"need a head count and a residual flag per layer "
                             f"of {layer_sizes}; got {heads}, {list(residuals)}")
        self.feat_drop = float(feat_drop)
        self.attn_drop = float(attn_drop)
        self.negative_slope = negative_slope
        # (in_dim, out_dim, heads, residual) per layer, as the JAX GAT.specs
        self.specs = [(in_feats, layer_sizes[0], heads[0], False)]
        for i in range(1, len(layer_sizes)):
            self.specs.append((layer_sizes[i - 1] * heads[i - 1], layer_sizes[i],
                               heads[i], bool(residuals[i])))
        self.specs.append((layer_sizes[-1] * heads[len(layer_sizes) - 1],
                           n_classes, 1, False))
        self.layers = nn.ModuleList(GatConv(*spec, generator=generator)
                                    for spec in self.specs)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def jax_parameters(self) -> list[nn.Parameter]:
        """The parameters in the JAX package's pytree flatten order (layer,
        then attn_l, attn_r, bias, w[, w_res]): the order of checkpoint
        leaves and of optimizer state leaves."""
        return [getattr(layer, k) for layer in self.layers for k in layer.keys]

    def forward(self, graph: GraphBatch, h: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> float32 logits [B, N, n_classes]. Feature and attention
        dropout apply only with train=True; `generator` (on the graph's
        device) draws them."""
        h = graph.feats if h is None else h
        for i, layer in enumerate(self.layers):
            last = i == self.num_layers - 1
            out = layer(graph, h, activation=not last,
                        feat_drop=self.feat_drop if train else 0.0,
                        attn_drop=self.attn_drop if train else 0.0,
                        negative_slope=self.negative_slope, generator=generator)
            B, N = out.shape[:2]
            h = out.mean(dim=2) if last else out.reshape(B, N, -1)
        return h.float()
