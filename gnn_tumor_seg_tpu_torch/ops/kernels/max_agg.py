"""Max aggregation with first-winner slots and its backward: the Hopper
kernels and their plain versions.

Replaces gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:135 `_max_kernel`
(launched by `tiled_aggregate_max_fwd`, gather_agg.py:166) and
gather_agg.py:200 `_max_bwd_kernel` (launched by `tiled_max_backward`,
gather_agg.py:238). Both kernels are CUDA C++ (csrc/max_agg.cu), built for
sm_90a with nvcc into a shared library with a plain C interface at first use
and loaded with ctypes; its header says what bounds them (bytes, and for the
backward the loads a thread keeps in flight) and what each design does
about that.

`max_aggregate` and `max_aggregate_backward` launch their kernel on a CUDA
tensor and take the plain version only for a CPU tensor; on a CUDA tensor
they launch the kernel or raise, never fall back. Each counts its kernel
launches in `.launches` and nothing else. `MaxAggregate` is the
torch.autograd.Function around both: its forward stores the uint8 winner
slots, its backward routes the gradient through them and the graph's `rslot`
table (ops/graph.py), as the JAX package's custom VJPs do
(gather_agg.py:278-307, ops/aggregate.py:112-182).
"""

from __future__ import annotations

import os

import torch

from ...build import build_cuda_library, check_launch

__all__ = ["max_aggregate", "max_aggregate_plain", "max_aggregate_backward",
           "max_aggregate_backward_plain", "MaxAggregate", "build"]

_NEG_LARGE = -1e30
_MAX_DEGREE = 128
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "max_agg.cu")

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("max_agg", _SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gts_max_agg_f32, lib.gts_max_agg_bf16):
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
        fn.restype = i32
    for fn in (lib.gts_max_agg_bwd_f32, lib.gts_max_agg_bwd_bf16):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
        fn.restype = i32
    _LIB = lib
    return log


def max_aggregate_plain(h: torch.Tensor, nbr: torch.Tensor,
                        nbr_mask: torch.Tensor):
    """Plain PyTorch version: h [B,N,F], nbr int [B,N,D], nbr_mask [B,N,D] ->
    (out [B,N,F] h.dtype, arg [B,N,F] uint8).

    A gather to [B,N,D,F], padded slots set to -1e30, the max over D; arg is
    the first slot equal to the max (0 for rows without a real slot), and
    rows without a real slot aggregate to 0. Same semantics as the JAX dense
    path (gnn_tumor_seg_tpu/ops/aggregate.py:55-67, :138-140)."""
    B, N, D = nbr.shape
    F = h.shape[-1]
    idx = nbr.long().reshape(B, N * D, 1).expand(B, N * D, F)
    g = torch.gather(h, 1, idx).reshape(B, N, D, F)
    valid = (nbr_mask > 0)[..., None]
    g = torch.where(valid, g, torch.full((), _NEG_LARGE, dtype=h.dtype,
                                         device=h.device))
    best = g.amax(dim=2)
    slot = torch.arange(D, device=h.device).view(1, 1, D, 1)
    arg = torch.where(g == best[:, :, None], slot, D).amin(dim=2)
    has_nbr = valid.any(dim=2)
    out = torch.where(has_nbr, best, torch.zeros((), dtype=h.dtype,
                                                 device=h.device))
    return out, arg.to(torch.uint8)


def max_aggregate_backward_plain(gout: torch.Tensor, arg: torch.Tensor,
                                 nbr: torch.Tensor, nbr_mask: torch.Tensor,
                                 rslot: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: gout [B,N,F], arg uint8 [B,N,F]
    (the forward's winner slots), nbr/nbr_mask/rslot [B,N,D] -> grad_h
    [B,N,F] in gout's dtype:

      grad[u,f] = sum_d [mask[u,d] > 0 and arg[v,f] == rslot[u,d]] gout[v,f],
      v = nbr[u,d],

    accumulated in float32 in slot order, as the kernel does, so the two are
    bitwise equal."""
    B, N, D = nbr.shape
    F = gout.shape[-1]
    acc = torch.zeros(gout.shape, dtype=torch.float32, device=gout.device)
    zero = torch.zeros((), dtype=torch.float32, device=gout.device)
    for d in range(D):
        idx = nbr[:, :, d].long()[..., None].expand(B, N, F)
        g_v = torch.gather(gout, 1, idx).float()
        a_v = torch.gather(arg, 1, idx)
        hit = ((a_v.int() == rslot[:, :, d, None].int())
               & (nbr_mask[:, :, d, None] > 0))
        acc = acc + torch.where(hit, g_v, zero)
    return acc.to(gout.dtype)


def _check_table(ref: torch.Tensor, nbr, nbr_mask, name: str) -> None:
    if ref.dim() != 3 or nbr.dim() != 3 or nbr.shape != nbr_mask.shape \
            or nbr.shape[:2] != ref.shape[:2]:
        raise ValueError(f"expected {name} [B,N,F] and nbr, nbr_mask [B,N,D]; "
                         f"got {tuple(ref.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(nbr_mask.shape)}")
    # before any other check, so a meta tensor of a graph too large is
    # refused for its size
    if ref.shape[1] * ref.shape[2] >= 2 ** 31:
        raise ValueError(f"the aggregation kernels index a graph's rows with "
                         f"32-bit integers; N*F = {ref.shape[1] * ref.shape[2]}"
                         f" >= 2**31")
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {ref.dtype}")
    if nbr.dtype != torch.int32 or nbr_mask.dtype != torch.float32:
        raise TypeError(f"nbr must be int32 and nbr_mask float32, got "
                        f"{nbr.dtype}, {nbr_mask.dtype}")
    if ref.device.type != "cuda" or not (nbr.device == nbr_mask.device
                                         == ref.device):
        raise ValueError(f"{name}, nbr and nbr_mask must be on one CUDA device")
    if not (ref.is_contiguous() and nbr.is_contiguous()
            and nbr_mask.is_contiguous()):
        raise ValueError(f"{name}, nbr and nbr_mask must be contiguous")
    if not 1 <= nbr.shape[2] <= _MAX_DEGREE:
        raise ValueError(f"degree padding must be in [1, {_MAX_DEGREE}], "
                         f"got {nbr.shape[2]}")


def max_aggregate(h: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor,
                  with_arg: bool = True):
    """(out, arg) as max_aggregate_plain; arg is None when with_arg is False
    (the serve path, which discards it: the kernel then skips its store).
    Not differentiable itself: training goes through MaxAggregate.

    nbr's real slots must index rows of h (ops/graph.ell_from_edges checks
    this when it builds the table)."""
    if h.device.type == "cpu":
        out, arg = max_aggregate_plain(h, nbr, nbr_mask)
        return out, (arg if with_arg else None)
    _check_table(h, nbr, nbr_mask, "h")
    if _LIB is None:
        build()
    B, N, F = h.shape
    D = nbr.shape[2]
    out = torch.empty_like(h)
    arg = (torch.empty(h.shape, dtype=torch.uint8, device=h.device)
           if with_arg else None)
    fn = (_LIB.gts_max_agg_f32 if h.dtype == torch.float32
          else _LIB.gts_max_agg_bf16)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(h.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(),
                out.data_ptr(), 0 if arg is None else arg.data_ptr(),
                B, N, D, F, int(with_arg), stream)
    check_launch(_LIB, rc, "max_agg")
    max_aggregate.launches += 1
    return out, arg


max_aggregate.launches = 0


def max_aggregate_backward(gout: torch.Tensor, arg: torch.Tensor,
                           nbr: torch.Tensor, nbr_mask: torch.Tensor,
                           rslot: torch.Tensor) -> torch.Tensor:
    """grad_h as max_aggregate_backward_plain. `rslot` must be the table's
    reciprocal slots (ops/graph.reciprocal_slots, which checks that the table
    is symmetric and deduplicated)."""
    if gout.device.type == "cpu":
        return max_aggregate_backward_plain(gout, arg, nbr, nbr_mask, rslot)
    _check_table(gout, nbr, nbr_mask, "gout")
    if arg.shape != gout.shape or arg.dtype != torch.uint8 \
            or arg.device != gout.device or not arg.is_contiguous():
        raise ValueError("arg must be a contiguous uint8 tensor shaped and "
                         "placed like gout")
    if rslot.shape != nbr.shape or rslot.dtype != torch.int32 \
            or rslot.device != gout.device or not rslot.is_contiguous():
        raise ValueError("rslot must be a contiguous int32 tensor shaped and "
                         "placed like nbr")
    if _LIB is None:
        build()
    B, N, F = gout.shape
    D = nbr.shape[2]
    grad = torch.empty_like(gout)
    fn = (_LIB.gts_max_agg_bwd_f32 if gout.dtype == torch.float32
          else _LIB.gts_max_agg_bwd_bf16)
    with torch.cuda.device(gout.device):
        stream = torch.cuda.current_stream(gout.device).cuda_stream
        rc = fn(gout.data_ptr(), arg.data_ptr(), nbr.data_ptr(),
                nbr_mask.data_ptr(), rslot.data_ptr(), grad.data_ptr(),
                B, N, D, F, stream)
    check_launch(_LIB, rc, "max_agg_bwd")
    max_aggregate_backward.launches += 1
    return grad


max_aggregate_backward.launches = 0


class MaxAggregate(torch.autograd.Function):
    """out = max over each row's real neighbour slots (0 for a row without
    one); the gradient goes to the first slot that attains the max, the
    subgradient of scatter-max backends (DGL, torch) and of the JAX package."""

    @staticmethod
    def forward(ctx, h, nbr, nbr_mask, rslot):
        out, arg = max_aggregate(h, nbr, nbr_mask, with_arg=True)
        ctx.save_for_backward(arg, nbr, nbr_mask, rslot)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        arg, nbr, nbr_mask, rslot = ctx.saved_tensors
        grad = max_aggregate_backward(gout.contiguous(), arg, nbr, nbr_mask,
                                      rslot)
        return grad, None, None, None
