"""SDDMM: sampled dense-dense matmul, per-edge scores from node embeddings
(counterpart of gnn_tumor_seg_tpu/ops/sddmm.py).

score[b, v, d, h] = < a[b, v, h, :], c[b, nbr[b, v, d], h, :] >   (masked)

The general per-edge similarity op (GAT's attention uses the cheaper
decomposed form a_l.z_src + a_r.z_dst). On a CUDA tensor it is the pair-dot
kernel of ops/kernels/weighted_sum.py (the port of `_pairdot_kernel`, the
JAX package's device path), float32 scores, not differentiable, as the
Pallas call is not; on a CPU tensor it is the JAX dense path, a gather and
an einsum, which autograd differentiates.
"""

from __future__ import annotations

import torch

from .kernels.weighted_sum import pairdot

__all__ = ["sddmm"]


def sddmm(a: torch.Tensor, c: torch.Tensor, nbr: torch.Tensor,
          nbr_mask: torch.Tensor) -> torch.Tensor:
    """a, c: [B, N, H, F]; nbr int32 [B, N, D], nbr_mask [B, N, D] ->
    scores [B, N, D, H], 0 on padded slots."""
    if a.device.type != "cpu":
        return pairdot(a, c, nbr, nbr_mask)
    B, N, H, F = a.shape
    D = nbr.shape[2]
    idx = nbr.long().reshape(B, N * D, 1).expand(B, N * D, H * F)
    c_src = torch.gather(c.reshape(B, N, H * F), 1, idx).reshape(B, N, D, H, F)
    scores = torch.einsum("bnhf,bndhf->bndh", a, c_src)
    return scores * (nbr_mask[..., None] > 0)
