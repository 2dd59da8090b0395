"""Neighbourhood aggregation over the ELL layout (counterpart of
gnn_tumor_seg_tpu/ops/aggregate.py).

Semantics, as DGL's reducers and the JAX package:
  sum:  padded slots contribute 0.
  mean: sum / max(real_degree, 1); nodes without in-edges aggregate to 0.
  max:  elementwise max over real neighbours; nodes without in-edges aggregate to 0.
  weighted (edge_weight, sum/mean only): sum_d w h, and for mean the
        weighted average sum_d w h / max(sum_d w, 1e-12).

max goes through the Hopper kernels of ops/kernels/max_agg.py, sum and mean
through those of ops/kernels/sum_agg.py, on a CUDA tensor; on a CPU tensor
each takes its plain version. When a gradient is needed the call goes
through the kernels' torch.autograd.Functions, whose backward passes are the
scatter-free gathers of a symmetric table (ops/aggregate.py:112-182 of the
JAX package); max then needs the graph's `rslot` table. Weighted sum/mean
are plain PyTorch on the CPU only: their kernel (the port of
weighted_sum._wsum_kernel) belongs to a later slice, and on a CUDA tensor
they raise.
"""

from __future__ import annotations

import torch

from .kernels import max_agg, sum_agg

__all__ = ["aggregate_neighbors"]

_VALID_OPS = ("sum", "mean", "max")


def _needs_grad(h: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and h.requires_grad


def _weighted(h, nbr, nbr_mask, edge_weight, op):
    """The JAX dense weighted path (ops/aggregate.py:196-203); autograd
    gives its gradient on the CPU."""
    if h.device.type != "cpu":
        raise NotImplementedError(
            f"weighted {op} aggregation on {h.device} needs the port of "
            "weighted_sum._wsum_kernel (ROADMAP.md, TPU kernels to port, "
            "'_wsum_kernel' row)")
    B, N, D = nbr.shape
    F = h.shape[-1]
    idx = nbr.long().reshape(B, N * D, 1).expand(B, N * D, F)
    g = torch.gather(h, 1, idx).reshape(B, N, D, F)
    wm = nbr_mask * edge_weight
    s = (g * wm[..., None].to(h.dtype)).sum(dim=2)
    if op == "sum":
        return s
    denom = wm.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return s / denom.to(h.dtype)


def aggregate_neighbors(h: torch.Tensor, nbr: torch.Tensor,
                        nbr_mask: torch.Tensor, op: str,
                        rslot: torch.Tensor | None = None,
                        edge_weight: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """h [B, N, F], nbr int32 [B, N, D], nbr_mask f32 [B, N, D] -> [B, N, F].

    rslot (int32 [B, N, D], ops/graph.reciprocal_slots) is needed for the
    gradient of max; edge_weight ([B, N, D]) weights sum/mean."""
    if op not in _VALID_OPS:
        raise ValueError(f"unknown aggregation {op!r}; expected {_VALID_OPS}")
    if edge_weight is not None:
        if op == "max":
            raise ValueError("edge weights apply to sum/mean aggregation only")
        return _weighted(h, nbr, nbr_mask, edge_weight, op)
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
