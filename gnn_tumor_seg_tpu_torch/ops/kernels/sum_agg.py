"""Sum and mean aggregation: the Hopper kernel and its plain version.

Replaces gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:68 `_sum_kernel`
(launched by `tiled_aggregate`, gather_agg.py:95). The kernel is CUDA C++
(csrc/sum_agg.cu), built for sm_90a with nvcc into a shared library with a
plain C interface at first use and loaded with ctypes, as max_agg.cu is; its
header says what bounds it (bytes) and what the design does about that.

`sum_aggregate` launches the kernel on a CUDA tensor and takes the plain
version, `sum_aggregate_plain`, only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises, never falls back. `sum_aggregate.launches`
counts kernel launches and nothing else. `SumAggregate` is the
torch.autograd.Function around it. On the symmetric table the same kernel is
its backward (gather_agg.py:295-304): grad_h = sum_aggregate(gout), for mean
of gout / max(deg, 1).
"""

from __future__ import annotations

import os

import torch

from ...build import build_cuda_library, check_launch
from .max_agg import _check_table

__all__ = ["sum_aggregate", "sum_aggregate_plain", "SumAggregate",
           "degrees", "build"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "sum_agg.cu")

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("sum_agg", _SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gts_sum_agg_f32, lib.gts_sum_agg_bf16):
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
        fn.restype = i32
    _LIB = lib
    return log


def degrees(nbr_mask: torch.Tensor) -> torch.Tensor:
    """float32 [B, N, 1]: each row's number of real slots, at least 1 (the
    mean's divisor; rows without an in-edge aggregate to 0)."""
    return (nbr_mask > 0).sum(dim=-1, keepdim=True).clamp_min(1).float()


def sum_aggregate_plain(h: torch.Tensor, nbr: torch.Tensor,
                        nbr_mask: torch.Tensor, mean: bool = False
                        ) -> torch.Tensor:
    """Plain PyTorch version: h [B,N,F], nbr int [B,N,D], nbr_mask [B,N,D] ->
    [B,N,F] in h's dtype: the sum over each row's real slots (mean: divided
    by max(deg, 1)), accumulated in float32 in slot order as the kernel
    does, so the two are bitwise equal. Same semantics as the JAX dense path
    (gnn_tumor_seg_tpu/ops/aggregate.py:55-62)."""
    B, N, D = nbr.shape
    F = h.shape[-1]
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    for d in range(D):
        idx = nbr[:, :, d].long()[..., None].expand(B, N, F)
        g = torch.gather(h, 1, idx).float()
        acc = acc + torch.where(nbr_mask[:, :, d, None] > 0, g, zero)
    if mean:
        acc = acc / degrees(nbr_mask)
    return acc.to(h.dtype)


def sum_aggregate(h: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor,
                  mean: bool = False) -> torch.Tensor:
    """As sum_aggregate_plain. Not differentiable itself: training goes
    through SumAggregate."""
    if h.device.type == "cpu":
        return sum_aggregate_plain(h, nbr, nbr_mask, mean)
    _check_table(h, nbr, nbr_mask, "h")
    if _LIB is None:
        build()
    B, N, F = h.shape
    D = nbr.shape[2]
    out = torch.empty_like(h)
    fn = (_LIB.gts_sum_agg_f32 if h.dtype == torch.float32
          else _LIB.gts_sum_agg_bf16)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(h.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(),
                out.data_ptr(), B, N, D, F, int(mean), stream)
    check_launch(_LIB, rc, "sum_agg")
    sum_aggregate.launches += 1
    return out


sum_aggregate.launches = 0


class SumAggregate(torch.autograd.Function):
    """Sum (mean=False) or mean over each row's real neighbour slots, with
    the scatter-free backward of a symmetric table."""

    @staticmethod
    def forward(ctx, h, nbr, nbr_mask, mean: bool):
        ctx.mean = mean
        ctx.save_for_backward(nbr, nbr_mask)
        return sum_aggregate(h, nbr, nbr_mask, mean)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        nbr, nbr_mask = ctx.saved_tensors
        if ctx.mean:
            gout = gout / degrees(nbr_mask).to(gout.dtype)
        grad = sum_aggregate(gout.contiguous(), nbr, nbr_mask, False)
        return grad, None, None, None
