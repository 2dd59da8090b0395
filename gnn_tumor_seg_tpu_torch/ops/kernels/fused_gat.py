"""Fused GAT attention and its gradient: the Hopper kernels and their plain
versions.

Replaces, in gnn_tumor_seg_tpu/ops/pallas/fused_gat.py,
  :103 `_fwd_kernel` (launched by `_fused_fwd_raw`, :350)  -> fused_gat_forward
  :186 `_bwd_kernel` (in `_fga_bwd`, :420)                 -> fused_gat_backward
  :238 `_bwd2_kernel` (via `_reverse_combine`, :311)       -> gat_reverse_combine
All three are CUDA C++ (csrc/fused_gat.cu), built for sm_90a with nvcc into
a shared library with a plain C interface at first use and loaded with
ctypes, as max_agg.cu is; its header gives the formulas, what bounds the
kernels (bytes, and the re-reads of gathered rows from L2) and what the
design does about that. The kernels pick their vector width from F and the
alignment of the feature tensors, so any contiguous tensor is taken.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
version (`*_plain`) only for a CPU tensor: on a CUDA tensor it launches the
kernel or raises, never falls back. Each counts its kernel launches in
`.launches` and nothing else. `fused_gat_attention` is the layer's entry:
without a gradient (serving, evaluation) it runs the forward alone and
stores neither alpha nor the sign mask; with one it goes through
`FusedGatAttention`, whose backward takes ELU' from the saved output
(fused_gat.py:426-428), then runs the backward and the reverse combine,
with d_res = gout and d_bias = gout summed over the rows as plain tensor
ops (:459-465). The el/er -> z chain stays in autograd (fused_gat.py:37).

Deviation from the TPU kernel: the forward stores the sign of the
pre-activation logits as a uint8 mask (1 where LeakyReLU's output is >= 0
on a real slot) in place of the bf16 logits, since the backward reads only
that sign.
"""

from __future__ import annotations

import os

import torch

from ...build import build_cuda_library, check_launch
from ...runtime import first_cpu_exp

__all__ = ["fused_gat_forward", "fused_gat_forward_plain", "fused_gat_backward",
           "fused_gat_backward_plain", "gat_reverse_combine",
           "gat_reverse_combine_plain", "fused_gat_attention",
           "FusedGatAttention", "ACTIVATIONS", "build"]

_NEG_LARGE = -1e30
ACTIVATIONS = (None, "elu")
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "fused_gat.cu")

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("fused_gat", _SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.gts_gat_fwd_f32, lib.gts_gat_fwd_bf16):
        fn.argtypes = [vp] * 10 + [i32] * 5 + [f32, i32, i32, vp]
        fn.restype = i32
    for fn in (lib.gts_gat_bwd_f32, lib.gts_gat_bwd_bf16):
        fn.argtypes = [vp] * 8 + [i32] * 5 + [f32, vp]
        fn.restype = i32
    for fn in (lib.gts_gat_rev_f32, lib.gts_gat_rev_bf16):
        fn.argtypes = [vp] * 8 + [i32] * 5 + [vp]
        fn.restype = i32
    _LIB = lib
    return log


# ----------------------------------------------------------------- plain


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, W], idx int [B, N] -> x[b, idx[b, n], :] as [B, N, W]."""
    W = x.shape[-1]
    return torch.gather(x, 1, idx.long()[..., None].expand(*idx.shape, W))


def fused_gat_forward_plain(z, el, er, nbr, nbr_mask, slope, act, res, bias,
                            save=True):
    """Plain PyTorch version of the forward: z [B,N,H,F], el/er [B,N,H]
    (z's dtype), nbr int32 and nbr_mask float32 [B,N,D], res [B,N,H*F] or
    None, bias [H*F] -> (out [B,N,H,F] in z's dtype, alpha float32
    [B,N,D*H], pos uint8 [B,N,D*H]); alpha and pos are None unless `save`.

    The kernel's arithmetic in its order: float32 throughout, the
    normaliser and the combine summed in slot order with one rounding per
    product and per add, alpha = w * (1 / max(sum, 1e-20)), and the
    epilogue ((combine + bias) + res, then ELU with its exp argument
    clamped at 0). The process's first CPU exp runs on one thread
    (runtime.first_cpu_exp) before the first one here."""
    first_cpu_exp()
    B, N, H, F = z.shape
    D = nbr.shape[2]
    f32 = torch.float32
    valid = (nbr_mask > 0)[..., None]                              # [B,N,D,1]
    el_src = _gather_rows(el, nbr.reshape(B, N * D)).reshape(B, N, D, H)
    p = el_src.to(f32) + er.to(f32)[:, :, None, :]
    pre = torch.where(p >= 0, p, p * slope)
    logit = torch.where(valid, pre, torch.full((), _NEG_LARGE, dtype=f32,
                                               device=z.device))
    mx = logit.amax(dim=2, keepdim=True)
    zero = torch.zeros((), dtype=f32, device=z.device)
    e = torch.where(valid, torch.exp(logit - mx), zero)
    total = torch.zeros((B, N, H), dtype=f32, device=z.device)
    for d in range(D):
        total = total + e[:, :, d]
    alpha = e * (1.0 / total.clamp_min(1e-20))[:, :, None]        # [B,N,D,H]
    zf = z.reshape(B, N, H * F)
    acc = torch.zeros((B, N, H, F), dtype=f32, device=z.device)
    for d in range(D):
        z_d = _gather_rows(zf, nbr[:, :, d]).to(f32).reshape(B, N, H, F)
        acc = acc + torch.where(valid[:, :, d, :, None],
                                alpha[:, :, d, :, None] * z_d, zero)
    v = acc.reshape(B, N, H * F) + bias.to(f32)
    if res is not None:
        v = v + res.to(f32)
    if act == "elu":
        v = torch.where(v > 0, v, torch.exp(v.clamp(max=0.0)) - 1.0)
    out = v.to(z.dtype).reshape(B, N, H, F)
    if not save:
        return out, None, None
    pos = (valid & (pre >= 0)).to(torch.uint8).reshape(B, N, D * H)
    return out, alpha.reshape(B, N, D * H), pos


def fused_gat_backward_plain(gout, z, alpha, pos, nbr, nbr_mask, slope=0.2):
    """Plain PyTorch version of the attention backward: gout and z
    [B,N,H,F] (one dtype; gout already multiplied by ELU'), alpha float32
    and pos uint8 [B,N,D*H] from the forward, nbr/nbr_mask [B,N,D] ->
    (d_pre float32 [B,N,D*H], d_er float32 [B,N,H]):

      d_alpha[v,d,h] = <gout[v,h,:], z[nbr[v,d],h,:]>
      d_pre          = mask * LeakyReLU'(pre) * alpha * (d_alpha - sum_d alpha d_alpha)
      d_er           = sum_d d_pre

    in float32, the sums over slots in slot order. The dot over F is
    torch's sum; the kernel takes another order (each lane's FMAs over its
    vectors of a head, then a shuffle tree over the head's lanes), so the
    two agree within a tolerance, not bitwise."""
    B, N, H, F = gout.shape
    D = nbr.shape[2]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=gout.device)
    valid = nbr_mask > 0                                           # [B,N,D]
    go = gout.to(f32)
    zf = z.reshape(B, N, H * F)
    d_alpha = torch.stack([
        torch.where(valid[:, :, d, None],
                    (go * _gather_rows(zf, nbr[:, :, d]).to(f32)
                     .reshape(B, N, H, F)).sum(-1), zero)
        for d in range(D)], dim=2)                                 # [B,N,D,H]
    a = alpha.reshape(B, N, D, H)
    s = torch.zeros((B, N, H), dtype=f32, device=gout.device)
    for d in range(D):
        s = s + a[:, :, d] * d_alpha[:, :, d]
    d_e = a * (d_alpha - s[:, :, None])
    d_p = torch.where(pos.reshape(B, N, D, H) > 0, d_e, d_e * slope)
    d_p = torch.where(valid[..., None], d_p, zero)
    d_er = torch.zeros((B, N, H), dtype=f32, device=gout.device)
    for d in range(D):
        d_er = d_er + d_p[:, :, d]
    return d_p.reshape(B, N, D * H), d_er


def gat_reverse_combine_plain(gout, alpha, d_pre, nbr, nbr_mask, rslot):
    """Plain PyTorch version of the reverse combine: gout [B,N,H,F], alpha
    and d_pre float32 [B,N,D*H], nbr/nbr_mask/rslot [B,N,D] ->
    (d_z [B,N,H,F] in gout's dtype, d_el float32 [B,N,H]):

      d_z[u,h,:] = sum_d alpha[v, rslot[u,d], h] * gout[v,h,:]
      d_el[u,h]  = sum_d d_pre[v, rslot[u,d], h],     v = nbr[u,d],

    over u's real slots, accumulated in float32 in slot order with one
    rounding per product and per add, as the kernel does, so the two are
    bitwise equal."""
    B, N, H, F = gout.shape
    D = nbr.shape[2]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=gout.device)
    gf = gout.reshape(B, N, H * F)
    a_flat = alpha.reshape(B, N * D, H)
    p_flat = d_pre.reshape(B, N * D, H)
    d_z = torch.zeros((B, N, H, F), dtype=f32, device=gout.device)
    d_el = torch.zeros((B, N, H), dtype=f32, device=gout.device)
    for d in range(D):
        v = nbr[:, :, d].long()
        edge = v * D + rslot[:, :, d].long()                        # [B,N]
        valid = nbr_mask[:, :, d, None] > 0
        a_rev = _gather_rows(a_flat, edge)                          # [B,N,H]
        p_rev = _gather_rows(p_flat, edge)
        g_v = _gather_rows(gf, v).to(f32).reshape(B, N, H, F)
        d_z = d_z + torch.where(valid[..., None], a_rev[..., None] * g_v, zero)
        d_el = d_el + torch.where(valid, p_rev, zero)
    return d_z.to(gout.dtype), d_el


# --------------------------------------------------------------- kernels


def _check_common(x, nbr, nbr_mask, name: str) -> None:
    if x.dim() != 4 or nbr.dim() != 3 or nbr.shape != nbr_mask.shape \
            or tuple(nbr.shape[:2]) != tuple(x.shape[:2]):
        raise ValueError(f"expected {name} [B,N,H,F] and nbr, nbr_mask "
                         f"[B,N,D]; got {tuple(x.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(nbr_mask.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if nbr.dtype != torch.int32 or nbr_mask.dtype != torch.float32:
        raise TypeError(f"nbr must be int32 and nbr_mask float32, got "
                        f"{nbr.dtype}, {nbr_mask.dtype}")
    # the limits on degree and heads live in fused_gat.cu (check_dims): a
    # launch beyond them fails with "invalid argument" in check_launch
    _check_tensors(x.device, [(x, name), (nbr, "nbr"), (nbr_mask, "nbr_mask")])


def _check_tensors(device, tensors) -> None:
    if device.type != "cuda":
        raise ValueError("the kernels run on a CUDA device")
    for t, name in tensors:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_like(t, shape, dtype, name: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_gat_forward(z, el, er, nbr, nbr_mask, slope, act, res, bias,
                      save=True):
    """(out, alpha, pos) as fused_gat_forward_plain; alpha and pos are None
    when `save` is False (serving and evaluation: the kernel then skips both
    stores). Not differentiable itself: training goes through
    FusedGatAttention."""
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")
    if z.device.type == "cpu":
        return fused_gat_forward_plain(z, el, er, nbr, nbr_mask, slope, act,
                                       res, bias, save)
    _check_common(z, nbr, nbr_mask, "z")
    B, N, H, F = z.shape
    D = nbr.shape[2]
    _check_like(el, (B, N, H), z.dtype, "el")
    _check_like(er, (B, N, H), z.dtype, "er")
    _check_like(bias, (H * F,), z.dtype, "bias")
    checked = [(el, "el"), (er, "er"), (bias, "bias")]
    if res is not None:
        _check_like(res, (B, N, H * F), z.dtype, "res")
        checked.append((res, "res"))
    _check_tensors(z.device, checked)
    if _LIB is None:
        build()
    out = torch.empty_like(z)
    alpha = pos = None
    if save:
        alpha = torch.empty((B, N, D * H), dtype=torch.float32, device=z.device)
        pos = torch.empty((B, N, D * H), dtype=torch.uint8, device=z.device)
    fn = _LIB.gts_gat_fwd_f32 if z.dtype == torch.float32 else _LIB.gts_gat_fwd_bf16
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), el.data_ptr(), er.data_ptr(), nbr.data_ptr(),
                nbr_mask.data_ptr(), bias.data_ptr(),
                None if res is None else res.data_ptr(), out.data_ptr(),
                None if alpha is None else alpha.data_ptr(),
                None if pos is None else pos.data_ptr(),
                B, N, D, H, F, float(slope), int(act == "elu"), int(save),
                _stream(z.device))
    check_launch(_LIB, rc, "gat_fwd")
    fused_gat_forward.launches += 1
    return out, alpha, pos


fused_gat_forward.launches = 0


def fused_gat_backward(gout, z, alpha, pos, nbr, nbr_mask, slope=0.2):
    """(d_pre, d_er) as fused_gat_backward_plain."""
    if gout.device.type == "cpu":
        return fused_gat_backward_plain(gout, z, alpha, pos, nbr, nbr_mask,
                                        slope)
    _check_common(gout, nbr, nbr_mask, "gout")
    B, N, H, F = gout.shape
    D = nbr.shape[2]
    _check_like(z, gout.shape, gout.dtype, "z")
    _check_like(alpha, (B, N, D * H), torch.float32, "alpha")
    _check_like(pos, (B, N, D * H), torch.uint8, "pos")
    _check_tensors(gout.device, [(z, "z"), (alpha, "alpha"), (pos, "pos")])
    if _LIB is None:
        build()
    d_pre = torch.empty((B, N, D * H), dtype=torch.float32, device=gout.device)
    d_er = torch.empty((B, N, H), dtype=torch.float32, device=gout.device)
    fn = (_LIB.gts_gat_bwd_f32 if gout.dtype == torch.float32
          else _LIB.gts_gat_bwd_bf16)
    with torch.cuda.device(gout.device):
        rc = fn(gout.data_ptr(), z.data_ptr(), alpha.data_ptr(), pos.data_ptr(),
                nbr.data_ptr(), nbr_mask.data_ptr(), d_pre.data_ptr(),
                d_er.data_ptr(), B, N, D, H, F, float(slope),
                _stream(gout.device))
    check_launch(_LIB, rc, "gat_bwd")
    fused_gat_backward.launches += 1
    return d_pre, d_er


fused_gat_backward.launches = 0


def gat_reverse_combine(gout, alpha, d_pre, nbr, nbr_mask, rslot):
    """(d_z, d_el) as gat_reverse_combine_plain. `rslot` must be the
    table's reciprocal slots (ops/graph.reciprocal_slots, which checks that
    the table is symmetric and deduplicated)."""
    if gout.device.type == "cpu":
        return gat_reverse_combine_plain(gout, alpha, d_pre, nbr, nbr_mask,
                                         rslot)
    _check_common(gout, nbr, nbr_mask, "gout")
    B, N, H, F = gout.shape
    D = nbr.shape[2]
    _check_like(alpha, (B, N, D * H), torch.float32, "alpha")
    _check_like(d_pre, (B, N, D * H), torch.float32, "d_pre")
    _check_like(rslot, nbr.shape, torch.int32, "rslot")
    _check_tensors(gout.device, [(alpha, "alpha"), (d_pre, "d_pre"),
                                 (rslot, "rslot")])
    if _LIB is None:
        build()
    d_z = torch.empty_like(gout)
    d_el = torch.empty((B, N, H), dtype=torch.float32, device=gout.device)
    fn = (_LIB.gts_gat_rev_f32 if gout.dtype == torch.float32
          else _LIB.gts_gat_rev_bf16)
    with torch.cuda.device(gout.device):
        rc = fn(gout.data_ptr(), alpha.data_ptr(), d_pre.data_ptr(),
                nbr.data_ptr(), nbr_mask.data_ptr(), rslot.data_ptr(),
                d_z.data_ptr(), d_el.data_ptr(), B, N, D, H, F,
                _stream(gout.device))
    check_launch(_LIB, rc, "gat_rev")
    gat_reverse_combine.launches += 1
    return d_z, d_el


gat_reverse_combine.launches = 0


# -------------------------------------------------------------- autograd


class FusedGatAttention(torch.autograd.Function):
    """out = act(sum_d alpha z[nbr] + bias + res) with alpha the masked edge
    softmax of LeakyReLU(el[nbr] + er); differentiable in z, el, er, res and
    bias, through the scatter-free backward of a symmetric table."""

    @staticmethod
    def forward(ctx, z, el, er, res, bias, nbr, nbr_mask, rslot, slope, act):
        out, alpha, pos = fused_gat_forward(z, el, er, nbr, nbr_mask, slope,
                                            act, res, bias, save=True)
        ctx.slope, ctx.act = slope, act
        ctx.dtypes = (el.dtype, er.dtype,
                      None if res is None else res.dtype, bias.dtype)
        ctx.save_for_backward(z, alpha, pos, nbr, nbr_mask, rslot,
                              out if act else None)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        z, alpha, pos, nbr, nbr_mask, rslot, y = ctx.saved_tensors
        el_dt, er_dt, res_dt, bias_dt = ctx.dtypes
        gout = gout.contiguous()
        if ctx.act:   # d/ds elu(s) = 1 where s > 0, else exp(s) = y + 1
            gout = gout * torch.where(y > 0, 1.0, y + 1.0).to(gout.dtype)
        d_pre, d_er = fused_gat_backward(gout, z, alpha, pos, nbr, nbr_mask,
                                         ctx.slope)
        d_z, d_el = gat_reverse_combine(gout, alpha, d_pre, nbr, nbr_mask,
                                        rslot)
        B, N, H, F = gout.shape
        flat = gout.reshape(B, N, H * F)
        d_res = None if res_dt is None else flat.to(res_dt)
        d_bias = flat.sum(dim=(0, 1)).to(bias_dt)
        return (d_z, d_el.to(el_dt), d_er.to(er_dt), d_res, d_bias,
                None, None, None, None, None)


def fused_gat_attention(z, el, er, bias, nbr, nbr_mask, rslot=None, slope=0.2,
                        act=None, res=None):
    """One GAT layer's attention and epilogue: z [B,N,H,F], el/er [B,N,H],
    bias [H*F], res [B,N,H*F] or None -> out [B,N,H,F] (z's dtype).

    When a gradient is needed the call goes through FusedGatAttention, which
    needs the graph's reciprocal slots `rslot`."""
    inputs = (z, el, er, bias) + (() if res is None else (res,))
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return fused_gat_forward(z, el, er, nbr, nbr_mask, slope, act, res,
                                 bias, save=False)[0]
    if rslot is None:
        raise ValueError(
            "the gradient of GAT attention needs the graph's reciprocal "
            "slots: build the graph with graph_from_arrays(..., rslot=True)")
    return FusedGatAttention.apply(z, el, er, res, bias, nbr, nbr_mask, rslot,
                                   slope, act)
