"""Neighbourhood aggregation over the ELL layout (counterpart of
gnn_tumor_seg_tpu/ops/aggregate.py).

Semantics, as DGL's reducers and the JAX package:
  sum:  padded slots contribute 0.
  mean: sum / max(real_degree, 1); nodes without in-edges aggregate to 0.
  max:  elementwise max over real neighbours; nodes without in-edges aggregate to 0.

max goes through the Hopper kernel (ops/kernels/max_agg.py) on a CUDA tensor
and through its plain version on a CPU tensor. sum and mean are plain PyTorch
on the CPU only: their kernel (the port of gather_agg._sum_kernel) belongs to
a later slice, and on a CUDA tensor they raise.
"""

from __future__ import annotations

import torch

from .kernels.max_agg import max_aggregate

__all__ = ["aggregate_neighbors"]

_VALID_OPS = ("sum", "mean", "max")


def aggregate_neighbors(h: torch.Tensor, nbr: torch.Tensor,
                        nbr_mask: torch.Tensor, op: str) -> torch.Tensor:
    """h [B, N, F], nbr int32 [B, N, D], nbr_mask f32 [B, N, D] -> [B, N, F]."""
    if op not in _VALID_OPS:
        raise ValueError(f"unknown aggregation {op!r}; expected {_VALID_OPS}")
    if op == "max":
        return max_aggregate(h, nbr, nbr_mask, with_arg=False)[0]
    if h.device.type != "cpu":
        raise NotImplementedError(
            f"{op} aggregation on {h.device} needs the port of "
            "gather_agg._sum_kernel (ROADMAP.md, TPU kernels to port, "
            "'_sum_kernel' row); only 'max' has a CUDA kernel so far")
    B, N, D = nbr.shape
    F = h.shape[-1]
    idx = nbr.long().reshape(B, N * D, 1).expand(B, N * D, F)
    g = torch.gather(h, 1, idx).reshape(B, N, D, F)
    m = nbr_mask[..., None].to(h.dtype)
    out = (g * m).sum(dim=2)
    if op == "mean":
        deg = nbr_mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
        out = out / deg.to(h.dtype)
    return out
