"""Edge-weighted neighbour combine and the per-edge pair dot: the Hopper
kernels and their plain versions.

Replaces, in gnn_tumor_seg_tpu/ops/pallas/weighted_sum.py,
  :86 `_wsum_kernel` (launched by `_wsum_raw`, :114)   -> weighted_sum, and
      in its VJP (`_tws_bwd`, :224) over the reverse weights
                                                       -> weighted_sum_reverse
  :144 `_pairdot_kernel` (launched by `_pairdot`, :173) -> pairdot
All are CUDA C++ (csrc/weighted_sum.cu), built for sm_90a with nvcc into a
shared library with a plain C interface at first use and loaded with
ctypes, as max_agg.cu is; its header gives the formulas, what bounds the
kernels (bytes) and what the design does about that: the combines run
threads flat over (row, feature vector), the pair dot a group of lanes per
(row, head) that reduces a chunk of slots' dots with shuffles and writes
the block's scores as one run. They index a graph with 32-bit integers, so
`pairdot` raises ValueError when N*H*F or N*D*H reaches 2**31.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
version (`*_plain`) only for a CPU tensor: on a CUDA tensor it launches the
kernel or raises, never falls back. Each counts its kernel launches in
`.launches` and nothing else. The weights are float32 in the kernels;
`weighted_combine`, the differentiable entry, casts them (GAT's alpha is
bf16 in "fast" mode). With a gradient it goes through `WeightedSum`, whose
backward is the same combine over the reverse weights, read through the
graph's `rslot` table inside the kernel (the TPU fetches them first,
`_reverse_weights`, :202), and the pair dot for the weights' gradient, run
only when the weights need one (GAT's alpha; a SAGE graph's edge weights
are data).
"""

from __future__ import annotations

import os

import torch

from ...build import build_cuda_library, check_launch
from .fused_gat import _check_common, _check_like, _check_tensors, _gather_rows, _stream

__all__ = ["weighted_sum", "weighted_sum_plain", "weighted_sum_reverse",
           "weighted_sum_reverse_plain", "pairdot", "pairdot_plain",
           "WeightedSum", "weighted_combine", "build"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "weighted_sum.cu")

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("weighted_sum", _SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gts_wsum_f32, lib.gts_wsum_bf16):
        fn.argtypes = [vp] * 6 + [i32] * 6 + [vp]
        fn.restype = i32
    for fn in (lib.gts_pairdot_f32, lib.gts_pairdot_bf16):
        fn.argtypes = [vp] * 5 + [i32] * 5 + [vp]
        fn.restype = i32
    _LIB = lib
    return log


# ----------------------------------------------------------------- plain


def weighted_sum_plain(values, weights, nbr, nbr_mask):
    """Plain PyTorch version: values [B,N,H,F], weights [B,N,D,H],
    nbr int [B,N,D], nbr_mask [B,N,D] -> [B,N,H,F] in values' dtype:

      out[v,h,:] = sum over v's real slots d of w[v,d,h] * values[nbr[v,d],h,:],

    a padded slot adding nothing whatever its weight; float32 arithmetic,
    summed in slot order with one rounding per product and per add, as the
    kernel does, so the two are bitwise equal."""
    B, N, H, F = values.shape
    D = nbr.shape[2]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=values.device)
    vf = values.reshape(B, N, H * F)
    w = weights.to(f32)
    acc = torch.zeros((B, N, H, F), dtype=f32, device=values.device)
    for d in range(D):
        v_d = _gather_rows(vf, nbr[:, :, d]).to(f32).reshape(B, N, H, F)
        acc = acc + torch.where(nbr_mask[:, :, d, None, None] > 0,
                                w[:, :, d, :, None] * v_d, zero)
    return acc.to(values.dtype)


def weighted_sum_reverse_plain(gout, weights, nbr, nbr_mask, rslot):
    """Plain PyTorch version of the combine over the reverse weights (the
    gradient of weighted_sum with respect to its values): gout [B,N,H,F],
    weights [B,N,D,H], nbr/nbr_mask/rslot [B,N,D] -> [B,N,H,F] in gout's
    dtype:

      out[u,h,:] = sum over u's real slots d of w[v, rslot[u,d], h] * gout[v,h,:],
      v = nbr[u,d],

    in the kernel's order, so the two are bitwise equal."""
    B, N, H, F = gout.shape
    D = nbr.shape[2]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=gout.device)
    gf = gout.reshape(B, N, H * F)
    w_flat = weights.to(f32).reshape(B, N * D, H)
    acc = torch.zeros((B, N, H, F), dtype=f32, device=gout.device)
    for d in range(D):
        v = nbr[:, :, d].long()
        w_rev = _gather_rows(w_flat, v * D + rslot[:, :, d].long())   # [B,N,H]
        g_v = _gather_rows(gf, v).to(f32).reshape(B, N, H, F)
        acc = acc + torch.where(nbr_mask[:, :, d, None, None] > 0,
                                w_rev[..., None] * g_v, zero)
    return acc.to(gout.dtype)


def pairdot_plain(a, c, nbr, nbr_mask):
    """Plain PyTorch version of the pair dot: a and c [B,N,H,F] (one dtype),
    nbr/nbr_mask [B,N,D] -> float32 [B,N,D,H]:

      s[v,d,h] = <a[v,h,:], c[nbr[v,d],h,:]> on a real slot, 0 on a padded one,

    in float32 (the dot over F is torch's sum, another order than the
    kernel's shuffle tree)."""
    B, N, H, F = a.shape
    D = nbr.shape[2]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=a.device)
    af = a.to(f32)
    cf = c.reshape(B, N, H * F)
    return torch.stack([
        torch.where(nbr_mask[:, :, d, None] > 0,
                    (af * _gather_rows(cf, nbr[:, :, d]).to(f32)
                     .reshape(B, N, H, F)).sum(-1), zero)
        for d in range(D)], dim=2)


# --------------------------------------------------------------- kernels


def _check_weights(x, weights, nbr, name: str) -> None:
    B, N, H, _ = x.shape
    _check_like(weights, (B, N, nbr.shape[2], H), torch.float32, name)
    _check_tensors(x.device, [(weights, name)])


def _launch_wsum(values, weights, nbr, nbr_mask, rslot, reverse: bool):
    if _LIB is None:
        build()
    B, N, H, F = values.shape
    D = nbr.shape[2]
    out = torch.empty_like(values)
    fn = _LIB.gts_wsum_f32 if values.dtype == torch.float32 else _LIB.gts_wsum_bf16
    with torch.cuda.device(values.device):
        rc = fn(values.data_ptr(), weights.data_ptr(), nbr.data_ptr(),
                nbr_mask.data_ptr(), None if rslot is None else rslot.data_ptr(),
                out.data_ptr(), B, N, D, H, F, int(reverse),
                _stream(values.device))
    check_launch(_LIB, rc, "wsum_bwd" if reverse else "wsum")
    return out


def weighted_sum(values, weights, nbr, nbr_mask):
    """As weighted_sum_plain; on the card the weights must be float32. Not
    differentiable itself: training goes through WeightedSum."""
    if values.device.type == "cpu":
        return weighted_sum_plain(values, weights, nbr, nbr_mask)
    _check_common(values, nbr, nbr_mask, "values")
    _check_weights(values, weights, nbr, "weights")
    out = _launch_wsum(values, weights, nbr, nbr_mask, None, reverse=False)
    weighted_sum.launches += 1
    return out


weighted_sum.launches = 0


def weighted_sum_reverse(gout, weights, nbr, nbr_mask, rslot):
    """As weighted_sum_reverse_plain. `rslot` must be the table's reciprocal
    slots (ops/graph.reciprocal_slots, which checks that the table is
    symmetric and deduplicated)."""
    if gout.device.type == "cpu":
        return weighted_sum_reverse_plain(gout, weights, nbr, nbr_mask, rslot)
    _check_common(gout, nbr, nbr_mask, "gout")
    _check_weights(gout, weights, nbr, "weights")
    _check_like(rslot, nbr.shape, torch.int32, "rslot")
    _check_tensors(gout.device, [(rslot, "rslot")])
    out = _launch_wsum(gout, weights, nbr, nbr_mask, rslot, reverse=True)
    weighted_sum_reverse.launches += 1
    return out


weighted_sum_reverse.launches = 0


def pairdot(a, c, nbr, nbr_mask):
    """As pairdot_plain."""
    if a.device.type == "cpu":
        return pairdot_plain(a, c, nbr, nbr_mask)
    # before any other check, so a meta tensor of a graph too large is
    # refused for its size
    if a.dim() == 4 and nbr.dim() == 3:
        N, H, F = a.shape[1:]
        for what, n in (("N*H*F", N * H * F), ("N*D*H", N * nbr.shape[2] * H)):
            if n >= 2 ** 31:
                raise ValueError(f"pairdot indexes a graph with 32-bit integers; "
                                 f"{what} = {n} >= 2**31")
    _check_common(a, nbr, nbr_mask, "a")
    _check_like(c, a.shape, a.dtype, "c")
    _check_tensors(a.device, [(c, "c")])
    if _LIB is None:
        build()
    B, N, H, F = a.shape
    D = nbr.shape[2]
    scores = torch.empty((B, N, D, H), dtype=torch.float32, device=a.device)
    fn = _LIB.gts_pairdot_f32 if a.dtype == torch.float32 else _LIB.gts_pairdot_bf16
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), c.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(),
                scores.data_ptr(), B, N, D, H, F, _stream(a.device))
    check_launch(_LIB, rc, "pairdot")
    pairdot.launches += 1
    return scores


pairdot.launches = 0


# -------------------------------------------------------------- autograd


class WeightedSum(torch.autograd.Function):
    """out[v,h,:] = sum_d w[v,d,h] values[nbr[v,d],h,:] over real slots;
    differentiable in values and weights through the scatter-free backward
    of a symmetric table. Exact for weights that are not symmetric."""

    @staticmethod
    def forward(ctx, values, weights, nbr, nbr_mask, rslot):
        ctx.save_for_backward(values if ctx.needs_input_grad[1] else None,
                              weights, nbr, nbr_mask, rslot)
        return weighted_sum(values, weights, nbr, nbr_mask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        values, weights, nbr, nbr_mask, rslot = ctx.saved_tensors
        gout = gout.contiguous()
        grad_values = grad_weights = None
        if ctx.needs_input_grad[0]:
            grad_values = weighted_sum_reverse(gout, weights, nbr, nbr_mask, rslot)
        if ctx.needs_input_grad[1]:
            grad_weights = pairdot(gout, values, nbr, nbr_mask).to(weights.dtype)
        return grad_values, grad_weights, None, None, None


def weighted_combine(values, weights, nbr, nbr_mask, rslot=None):
    """values [B,N,H,F], weights [B,N,D,H] -> [B,N,H,F] (values' dtype):
    the weighted sum over each row's real neighbour slots, the weights cast
    to float32 first. When a gradient is needed the call goes through
    WeightedSum, which needs the graph's reciprocal slots `rslot`."""
    values = values.contiguous()
    weights = weights.float().contiguous()
    if not (torch.is_grad_enabled()
            and (values.requires_grad or weights.requires_grad)):
        return weighted_sum(values, weights, nbr, nbr_mask)
    if rslot is None:
        raise ValueError(
            "the gradient of the weighted sum needs the graph's reciprocal "
            "slots: build the graph with graph_from_arrays(..., rslot=True)")
    return WeightedSum.apply(values, weights, nbr, nbr_mask, rslot)
