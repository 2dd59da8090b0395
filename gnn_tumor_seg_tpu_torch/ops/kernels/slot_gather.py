"""Per-slot neighbour gather and its gradient: the Hopper kernels and their
plain versions.

Replaces gnn_tumor_seg_tpu/ops/pallas/slot_gather.py:58
`_slot_gather_kernel` (launched by `_slot_gather_raw`, slot_gather.py:84),
forward and backward (`_slot_gather_bwd`, :121-133). Both kernels are CUDA
C++ (csrc/slot_gather.cu), built for sm_90a with nvcc into a shared library
with a plain C interface at first use and loaded with ctypes, as max_agg.cu
is; its header says what bounds them (bytes and launch latency) and what
the design does about that.

`slot_gather` and `slot_gather_backward` launch their kernel on a CUDA
tensor and take the plain version only for a CPU tensor; on a CUDA tensor
they launch the kernel or raise, never fall back. Each counts its kernel
launches in `.launches` and nothing else. `SlotGather` is the
torch.autograd.Function around both, and `gather_slots` the differentiable
entry, which the decomposed GAT path uses for each slot's el (W = heads):
its gradient reads the cotangent of the reverse edge through the graph's
`rslot` table (ops/graph.py), as the JAX custom VJP does.
"""

from __future__ import annotations

import os

import torch

from ...build import build_cuda_library, check_launch
from .fused_gat import _check_like, _check_tensors, _gather_rows, _stream
from .max_agg import _check_table

__all__ = ["slot_gather", "slot_gather_plain", "slot_gather_backward",
           "slot_gather_backward_plain", "SlotGather", "gather_slots", "build"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "slot_gather.cu")

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("slot_gather", _SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gts_slot_gather_f32, lib.gts_slot_gather_bf16):
        fn.argtypes = [vp] * 4 + [i32] * 4 + [vp]
        fn.restype = i32
    for fn in (lib.gts_slot_gather_bwd_f32, lib.gts_slot_gather_bwd_bf16):
        fn.argtypes = [vp] * 5 + [i32] * 4 + [vp]
        fn.restype = i32
    _LIB = lib
    return log


def slot_gather_plain(x: torch.Tensor, nbr: torch.Tensor,
                      nbr_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [B,N,W], nbr int [B,N,D], nbr_mask [B,N,D]
    -> [B,N,D,W] in x's dtype, x[b, nbr[b,v,d], :] on a real slot and 0 on
    a padded one (the JAX dense gather times the mask)."""
    B, N, D = nbr.shape
    W = x.shape[-1]
    g = _gather_rows(x, nbr.reshape(B, N * D)).reshape(B, N, D, W)
    return torch.where((nbr_mask > 0)[..., None], g,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def slot_gather_backward_plain(gout: torch.Tensor, nbr: torch.Tensor,
                               nbr_mask: torch.Tensor,
                               rslot: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gradient: gout [B,N,D,W],
    nbr/nbr_mask/rslot [B,N,D] -> grad_x [B,N,W] in gout's dtype:

      grad[u,:] = sum over u's real slots d of gout[v, rslot[u,d], :],
      v = nbr[u,d],

    accumulated in float32 in slot order, as the kernel does, so the two are
    bitwise equal."""
    B, N, D, W = gout.shape
    flat = gout.reshape(B, N * D, W)
    acc = torch.zeros((B, N, W), dtype=torch.float32, device=gout.device)
    zero = torch.zeros((), dtype=torch.float32, device=gout.device)
    for d in range(D):
        edge = nbr[:, :, d].long() * D + rslot[:, :, d].long()
        g = _gather_rows(flat, edge).float()
        acc = acc + torch.where(nbr_mask[:, :, d, None] > 0, g, zero)
    return acc.to(gout.dtype)


def slot_gather(x: torch.Tensor, nbr: torch.Tensor,
                nbr_mask: torch.Tensor) -> torch.Tensor:
    """As slot_gather_plain. Not differentiable itself: training goes
    through SlotGather."""
    if x.device.type == "cpu":
        return slot_gather_plain(x, nbr, nbr_mask)
    _check_table(x, nbr, nbr_mask, "x")
    if _LIB is None:
        build()
    B, N, W = x.shape
    D = nbr.shape[2]
    if B * N * D * W >= 2 ** 31:
        raise ValueError(f"slot_gather indexes its output with 32-bit "
                         f"integers; B*N*D*W = {B * N * D * W} >= 2**31")
    out = torch.empty((B, N, D, W), dtype=x.dtype, device=x.device)
    fn = (_LIB.gts_slot_gather_f32 if x.dtype == torch.float32
          else _LIB.gts_slot_gather_bf16)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(),
                out.data_ptr(), B, N, D, W, _stream(x.device))
    check_launch(_LIB, rc, "slot_gather")
    slot_gather.launches += 1
    return out


slot_gather.launches = 0


def slot_gather_backward(gout: torch.Tensor, nbr: torch.Tensor,
                         nbr_mask: torch.Tensor,
                         rslot: torch.Tensor) -> torch.Tensor:
    """grad_x as slot_gather_backward_plain. `rslot` must be the table's
    reciprocal slots (ops/graph.reciprocal_slots, which checks that the
    table is symmetric and deduplicated)."""
    if gout.device.type == "cpu":
        return slot_gather_backward_plain(gout, nbr, nbr_mask, rslot)
    if gout.dim() != 4 or tuple(nbr.shape) != tuple(gout.shape[:3]):
        raise ValueError(f"expected gout [B,N,D,W] and nbr [B,N,D]; got "
                         f"{tuple(gout.shape)}, {tuple(nbr.shape)}")
    B, N, D, W = gout.shape
    _check_tensors(gout.device, [(gout, "gout"), (rslot, "rslot")])
    _check_table(gout.view(B, N, D * W), nbr, nbr_mask, "gout")
    _check_like(rslot, nbr.shape, torch.int32, "rslot")
    if _LIB is None:
        build()
    grad = torch.empty((B, N, W), dtype=gout.dtype, device=gout.device)
    fn = (_LIB.gts_slot_gather_bwd_f32 if gout.dtype == torch.float32
          else _LIB.gts_slot_gather_bwd_bf16)
    with torch.cuda.device(gout.device):
        rc = fn(gout.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(),
                rslot.data_ptr(), grad.data_ptr(), B, N, D, W,
                _stream(gout.device))
    check_launch(_LIB, rc, "slot_gather_bwd")
    slot_gather_backward.launches += 1
    return grad


slot_gather_backward.launches = 0


class SlotGather(torch.autograd.Function):
    """out[b,v,d,:] = x[b, nbr[b,v,d], :] on real slots (0 on padded ones),
    with the scatter-free backward of a symmetric table."""

    @staticmethod
    def forward(ctx, x, nbr, nbr_mask, rslot):
        ctx.save_for_backward(nbr, nbr_mask, rslot)
        return slot_gather(x, nbr, nbr_mask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        nbr, nbr_mask, rslot = ctx.saved_tensors
        grad = slot_gather_backward(gout.contiguous(), nbr, nbr_mask, rslot)
        return grad, None, None, None


def gather_slots(x: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor,
                 rslot: torch.Tensor | None = None) -> torch.Tensor:
    """x [B,N,W] -> [B,N,D,W], each slot's neighbour row (0 on padded
    slots). When a gradient is needed the call goes through SlotGather,
    which needs the graph's reciprocal slots `rslot`."""
    x = x.contiguous()
    if not (torch.is_grad_enabled() and x.requires_grad):
        return slot_gather(x, nbr, nbr_mask)
    if rslot is None:
        raise ValueError(
            "the gradient of the slot gather needs the graph's reciprocal "
            "slots: build the graph with graph_from_arrays(..., rslot=True)")
    return SlotGather.apply(x, nbr, nbr_mask, rslot)
