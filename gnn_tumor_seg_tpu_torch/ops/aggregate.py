"""Neighbourhood aggregation over the ELL layout (counterpart of
gnn_tumor_seg_tpu/ops/aggregate.py).

Semantics, as DGL's reducers and the JAX package:
  sum:  padded slots contribute 0.
  mean: sum / max(real_degree, 1); nodes without in-edges aggregate to 0.
  max:  elementwise max over real neighbours; nodes without in-edges aggregate to 0.
  weighted (edge_weight, sum/mean only): sum_d w h, and for mean the
        weighted average sum_d w h / max(sum_d w, 1e-12).

max goes through the Hopper kernels of ops/kernels/max_agg.py, sum and mean
through those of ops/kernels/sum_agg.py, and weighted sum and mean through
the weighted combine of ops/kernels/weighted_sum.py with one head, as the
JAX package's Pallas path does (ops/aggregate.py:273-288): the weights cast
to float32, the mean divided by max(sum_d mask w, 1e-12) afterwards. On a
CUDA tensor each launches its kernel; on a CPU tensor each takes its plain
version. When a gradient is needed the call goes through the kernels'
torch.autograd.Functions, whose backward passes are the scatter-free
gathers of a symmetric table (ops/aggregate.py:112-182 of the JAX package);
max and the weighted combine then need the graph's `rslot` table. The
weighted gradient is exact for weights that are not symmetric too (the JAX
dense VJP `_wagg_symmetric` assumes symmetric ones).
"""

from __future__ import annotations

import torch

from .kernels import max_agg, sum_agg, weighted_sum

__all__ = ["aggregate_neighbors"]

_VALID_OPS = ("sum", "mean", "max")


def _needs_grad(h: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and h.requires_grad


def _weighted(h, nbr, nbr_mask, edge_weight, op, rslot):
    s = weighted_sum.weighted_combine(h[:, :, None, :], edge_weight[..., None],
                                      nbr, nbr_mask, rslot)[:, :, 0, :]
    if op == "sum":
        return s
    denom = (nbr_mask * edge_weight).sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return (s / denom).to(h.dtype)


def aggregate_neighbors(h: torch.Tensor, nbr: torch.Tensor,
                        nbr_mask: torch.Tensor, op: str,
                        rslot: torch.Tensor | None = None,
                        edge_weight: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """h [B, N, F], nbr int32 [B, N, D], nbr_mask f32 [B, N, D] -> [B, N, F].

    rslot (int32 [B, N, D], ops/graph.reciprocal_slots) is needed for the
    gradient of max and of the weighted sum/mean; edge_weight ([B, N, D])
    weights sum/mean."""
    if op not in _VALID_OPS:
        raise ValueError(f"unknown aggregation {op!r}; expected {_VALID_OPS}")
    if edge_weight is not None:
        if op == "max":
            raise ValueError("edge weights apply to sum/mean aggregation only")
        return _weighted(h, nbr, nbr_mask, edge_weight, op, rslot)
    if op == "max":
        if not _needs_grad(h):
            return max_agg.max_aggregate(h, nbr, nbr_mask, with_arg=False)[0]
        if rslot is None:
            raise ValueError(
                "the gradient of max aggregation needs the graph's reciprocal "
                "slots: build the graph with graph_from_arrays(..., rslot=True)")
        return max_agg.MaxAggregate.apply(h, nbr, nbr_mask, rslot)
    if not _needs_grad(h):
        return sum_agg.sum_aggregate(h, nbr, nbr_mask, op == "mean")
    return sum_agg.SumAggregate.apply(h, nbr, nbr_mask, op == "mean")
