"""GraphGPS's GatedGCN edge block (models/gps.py): the Hopper kernels and
their plain version.

Replaces no Pallas kernel: GraphGPS has no JAX counterpart. The block runs
from the edge tensors eW = e @ w_c, e_j = E h_j and b_j = B h_j (each [B, N,
D, W], the last two from the slot gather) and the node tensors d = D h_i + b
and a = A h_i + b ([B, N, W]) to the gate's node output and the edge
update (module doc of models/gps.py):

  ê  = (eW + e_j + d) on the real slots, 0 on the padded ones
  σ  = sigmoid(ê) ;  x = a + Σ_slots σ ⊙ b_j / (Σ_real slots σ + GATE_EPS)
  e' = e + ReLU(BN_e(ê))       (layers with an edge update; BatchNorm over
                                the `count` real slots, masked as
                                MaskedBatchNorm does)

Under dropout the edge update is e + keep ⊙ ReLU(BN_e(ê)) / (1 - rate),
`drop` = (keep, rate), keep a bool [B, N, D, W] mask that the caller draws
(models/gps.py, after the node's mask, in the generator's order the layer
always drew them); the kernels take it as an input, as the plain version
does.

`gated_edge_plain` is that composition in plain PyTorch, as models/gps.py
ran it before the kernels; autograd gives its backward. The kernels
(csrc/gated_edge.cu: the forward's `gated_edge_gate_kernel`,
`gated_edge_stats_kernel` and `gated_edge_update_kernel`, the backward's
`gated_edge_relu_grad_kernel`, `gated_edge_stats_grad_kernel` and
`gated_edge_gate_grad_kernel`) are CUDA C++ built for sm_90a with nvcc into
a shared library with a plain C interface at first use and loaded with
ctypes, as max_agg.cu is. Bytes bound them; the header of the source says
what the design does about that (a row's slots in one thread's registers,
padded slots never read, per-block channel sums reduced in a fixed order: no
atomics, so two launches on the same inputs are bitwise equal). They compute
in float32 and store in the inputs' type (float32 or bfloat16); padded slots
of e' and of ê's gradient are 0, those of b_j's gradient unwritten (the slot
gather's backward reads real slots only). The GEMMs stay cuBLAS calls
through torch: eW = e @ w_c forward, and backward de = g + dê @ w_cᵀ (one
addmm) and dw_c = eᵀ dê.

`gated_edge` is the entry models/gps.py calls: it takes the plain version
for a CPU tensor, and on any other device GatedEdge (the kernels and their
backward) or, without a gradient, the forward kernels alone, with or
without dropout: it launches them or raises, never falls back. `gated_edge_forward` and `gated_edge_backward` count their
kernel launches in `.launches` (3 + 3 a layer with an edge update, 1 + 1
without). Both index with 32-bit integers and raise ValueError when
B*N*D*W reaches 2**31.
"""

from __future__ import annotations

import os

import torch

from ...build import build_cuda_library, check_launch
from .fused_gat import _check_like, _check_tensors, _stream

__all__ = ["gated_edge", "gated_edge_plain", "gated_edge_forward",
           "gated_edge_backward", "GatedEdge", "build", "GATE_EPS"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "gated_edge.cu")

GATE_EPS = 1e-6
# a row block's threads at most (csrc/gated_edge.cu kRowThreads): a row's
# W / V threads, V channels each, fit one block
_ROW_THREADS = 384
# rows of the statistics (csrc/gated_edge.cu Stat)
_N_STATS = 7

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("gated_edge", _SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gts_gated_edge_rows.argtypes = [i32, i32]
    lib.gts_gated_edge_rows.restype = i32
    lib.gts_gated_edge_gate.argtypes = [i32, i32] + [vp] * 11 + [i32] * 3 + [f32, vp]
    lib.gts_gated_edge_stats.argtypes = [i32, vp, i32] + [vp] * 6 + [i32, f32, f32, i32, vp]
    lib.gts_gated_edge_update.argtypes = ([i32, i32] + [vp] * 5 + [f32, vp]
                                          + [i32] * 3 + [vp])
    lib.gts_gated_edge_relu_grad.argtypes = ([i32, i32] + [vp] * 5 + [f32, vp]
                                             + [i32] * 3 + [vp])
    lib.gts_gated_edge_stats_grad.argtypes = [vp, i32] + [vp] * 6 + [i32, i32, vp]
    lib.gts_gated_edge_gate_grad.argtypes = ([i32, i32] + [vp] * 10 + [f32] + [vp] * 3
                                             + [i32] * 3 + [f32, vp])
    for fn in (lib.gts_gated_edge_gate, lib.gts_gated_edge_stats,
               lib.gts_gated_edge_update, lib.gts_gated_edge_relu_grad,
               lib.gts_gated_edge_stats_grad, lib.gts_gated_edge_gate_grad):
        fn.restype = i32
    _LIB = lib
    return log


def gated_edge_plain(e, w_c, e_j, b_j, d, a, emask, pad_slots, bn, count,
                     train: bool, drop=None):
    """The block in plain PyTorch (module doc): e, e_j, b_j [B, N, D, W], w_c
    [W, W], d, a [B, N, W], all in the compute type; emask [B, N, D] float32,
    pad_slots [B, N, 1] each row's padded slots, `bn` the layer's
    MaskedBatchNorm (None: no edge update), `count` the real slots (a device
    scalar), `drop` None or (keep, rate), the edge update's dropout (module
    doc). -> (x [B, N, W], e' [B, N, D, W] or None).

    ê is masked once: 0 on padded slots, whose sigmoid 1/2 the denominator
    takes out again (b_j is 0 there, so the numerator needs nothing), and
    BN_e reads it with mask None, so e's padded slots stay unread."""
    cd = e.dtype
    e_hat = ((e @ w_c).add_(e_j).add_(d[:, :, None, :])
             .mul_(emask[..., None].to(cd)))
    sigma = torch.sigmoid(e_hat)
    den = sigma.sum(2, dtype=torch.float32) - 0.5 * pad_slots
    num = (sigma * b_j).sum(2, dtype=torch.float32)
    x = a + (num / (den + GATE_EPS)).to(cd)
    if bn is None:
        return x, None
    e_new = torch.relu(bn(e_hat, None, count, train))
    if drop is not None:
        keep, rate = drop
        e_new = torch.where(keep, e_new / (1.0 - rate),
                            torch.zeros((), dtype=cd, device=e.device))
    return x, e + e_new


def _dims(ew, e_j, b_j, d, a, emask):
    """(B, N, D, W) of the edge tensors; raises ValueError on other shapes or
    types, widths past the kernels' and 32-bit overflow."""
    if ew.dim() != 4:
        raise ValueError(f"expected eW [B, N, D, W], got {tuple(ew.shape)}")
    B, N, D, W = ew.shape
    if ew.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the gated edge kernels take float32 or bfloat16, got {ew.dtype}")
    if W > _ROW_THREADS:
        raise ValueError(f"the gated edge kernels take widths up to {_ROW_THREADS}; got {W}")
    if B * N * D * W >= 2 ** 31:
        raise ValueError(f"the gated edge kernels index with 32-bit integers; "
                         f"B*N*D*W = {B * N * D * W} >= 2**31")
    for t, name in ((e_j, "e_j"), (b_j, "b_j")):
        _check_like(t, ew.shape, ew.dtype, name)
    for t, name in ((d, "d"), (a, "a")):
        _check_like(t, (B, N, W), ew.dtype, name)
    _check_like(emask, (B, N, D), torch.float32, "emask")
    return B, N, D, W


def _vec(tensors, W: int, dtype) -> int:
    """Channels a thread loads at once: 8 bytes of them when W divides and
    every pointer is 16-byte aligned (as torch allocates), else 1."""
    v = 8 // dtype.itemsize
    if W % v or any(t.data_ptr() % 16 for t in tensors if t is not None):
        return 1
    return v


def _keep(drop, shape, bn):
    """(keep mask or None, scale 1 / (1 - rate)) of `drop` (module doc),
    checked: a bool mask like the edge tensors, only with an edge update."""
    if drop is None:
        return None, 1.0
    keep, rate = drop
    if bn is None:
        raise ValueError("dropout acts on the edge update: drop needs bn")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"the dropout rate must lie in (0, 1), got {rate}")
    _check_like(keep, shape, torch.bool, "keep")
    return keep, 1.0 / (1.0 - rate)


def _bn_tensors(bn, W):
    """The BatchNorm's g, b and running statistics, each float32 [W]."""
    out = (bn.g, bn.b, bn.running_mean, bn.running_var)
    for t, name in zip(out, ("g", "b", "running_mean", "running_var")):
        _check_like(t, (W,), torch.float32, f"bn.{name}")
    return out


def gated_edge_forward(ew, e_j, b_j, d, a, emask, e=None, bn=None, count=None,
                       train: bool = False, save: bool = True, drop=None):
    """The forward kernels from eW = e @ w_c: -> (x, e' or None, saved), saved
    (ê, den, num, stats) for gated_edge_backward, or None without `save`.

    With `bn` (the layer's MaskedBatchNorm; e and the real slots' `count`,
    a float32 device scalar, with it) the edge update runs: in training
    over the batch's statistics, whose running ones it updates in place, in
    evaluation over the running ones; `drop` (module doc) drops its ReLU's
    output. Not differentiable itself: training goes through GatedEdge."""
    B, N, D, W = _dims(ew, e_j, b_j, d, a, emask)
    keep, scale = _keep(drop, ew.shape, bn)
    if _LIB is None:
        build()
    dev = ew.device
    checked = [(ew, "eW"), (e_j, "e_j"), (b_j, "b_j"), (d, "d"), (a, "a"),
               (emask, "emask")]
    if bn is not None:
        _check_like(e, ew.shape, ew.dtype, "e")
        _check_like(count, (), torch.float32, "count")
        checked += [(e, "e"), (count, "count")]
        checked += [(t, "bn") for t in _bn_tensors(bn, W)]
    if keep is not None:
        checked.append((keep, "keep"))
    _check_tensors(dev, checked)
    R = B * N
    bf16 = int(ew.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.empty_like(a)
    e_hat = torch.empty_like(ew) if (save or bn is not None) else None
    den = torch.empty((B, N, W), **f32) if save else None
    num = torch.empty((B, N, W), **f32) if save else None
    V = _vec([ew, e_j, b_j, d, a, x, e_hat, den, num, e], W, ew.dtype)
    P = -(-R // _LIB.gts_gated_edge_rows(W, V))
    part = torch.empty((2, P, W), **f32) if (bn is not None and train) else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    s = _stream(dev)
    with torch.cuda.device(dev):
        rc = _LIB.gts_gated_edge_gate(bf16, V, ew.data_ptr(), e_j.data_ptr(),
                                      b_j.data_ptr(), d.data_ptr(), a.data_ptr(),
                                      emask.data_ptr(), ptr(e_hat), x.data_ptr(),
                                      ptr(den), ptr(num), ptr(part), R, D, W,
                                      GATE_EPS, s)
        check_launch(_LIB, rc, "gated_edge_gate")
        gated_edge_forward.launches += 1
        e_new = stats = None
        if bn is not None:
            g, b, rm, rv = _bn_tensors(bn, W)
            stats = torch.empty((_N_STATS, W), **f32)
            rc = _LIB.gts_gated_edge_stats(bf16, ptr(part), P, count.data_ptr(),
                                           g.data_ptr(), b.data_ptr(), rm.data_ptr(),
                                           rv.data_ptr(), stats.data_ptr(), W,
                                           bn.eps, bn.momentum, int(train), s)
            check_launch(_LIB, rc, "gated_edge_stats")
            e_new = torch.empty_like(e)
            rc = _LIB.gts_gated_edge_update(bf16, V, e.data_ptr(), e_hat.data_ptr(),
                                            emask.data_ptr(), stats.data_ptr(),
                                            ptr(keep), scale, e_new.data_ptr(), R, D,
                                            W, s)
            check_launch(_LIB, rc, "gated_edge_update")
            gated_edge_forward.launches += 2
    return x, e_new, ((e_hat, den, num, stats) if save else None)


gated_edge_forward.launches = 0


def gated_edge_backward(dx, de_new, e_hat, b_j, emask, den, num, stats, g, count,
                        train: bool, drop=None):
    """The backward kernels: the forward's saved (ê, den, num, stats), b_j,
    emask, the BatchNorm's g and `count`, the forward's `drop`, and the
    gradients dx [B, N, W] and de_new [B, N, D, W] (None without an edge
    update) -> (dê [B, N, D, W], db_j [B, N, D, W], dd [B, N, W], dg [W],
    db [W]), dg and db None without an edge update. dê is also the gradient
    of eW and of e_j."""
    B, N, D, W = _dims(e_hat, b_j, b_j, dx, dx, emask)
    bn = de_new is not None
    keep, scale = _keep(drop, e_hat.shape, g if bn else None)
    if _LIB is None:
        build()
    dev = e_hat.device
    checked = [(dx, "dx"), (e_hat, "e_hat"), (b_j, "b_j"), (emask, "emask"),
               (den, "den"), (num, "num")]
    _check_like(den, (B, N, W), torch.float32, "den")
    _check_like(num, (B, N, W), torch.float32, "num")
    if bn:
        _check_like(de_new, e_hat.shape, e_hat.dtype, "de_new")
        _check_like(stats, (_N_STATS, W), torch.float32, "stats")
        _check_like(g, (W,), torch.float32, "g")
        _check_like(count, (), torch.float32, "count")
        checked += [(de_new, "de_new"), (stats, "stats"), (g, "g"), (count, "count")]
    if keep is not None:
        checked.append((keep, "keep"))
    _check_tensors(dev, checked)
    R = B * N
    bf16 = int(e_hat.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=dev)
    dt = torch.empty_like(e_hat)
    db_j = torch.empty_like(e_hat)
    dd = torch.empty_like(dx)
    V = _vec([dx, e_hat, b_j, den, num, de_new, dt, db_j, dd], W, e_hat.dtype)
    s = _stream(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    dg = db = kk = None
    with torch.cuda.device(dev):
        if bn:
            P = -(-R // _LIB.gts_gated_edge_rows(W, V))
            part = torch.empty((2, P, W), **f32)
            rc = _LIB.gts_gated_edge_relu_grad(bf16, V, de_new.data_ptr(),
                                               e_hat.data_ptr(), emask.data_ptr(),
                                               stats.data_ptr(), ptr(keep), scale,
                                               part.data_ptr(), R, D, W, s)
            check_launch(_LIB, rc, "gated_edge_relu_grad")
            dg = torch.empty((W,), **f32)
            db = torch.empty((W,), **f32)
            kk = torch.empty((2, W), **f32)
            rc = _LIB.gts_gated_edge_stats_grad(part.data_ptr(), P, count.data_ptr(),
                                                g.data_ptr(), stats.data_ptr(),
                                                dg.data_ptr(), db.data_ptr(),
                                                kk.data_ptr(), W, int(train), s)
            check_launch(_LIB, rc, "gated_edge_stats_grad")
            gated_edge_backward.launches += 2
        rc = _LIB.gts_gated_edge_gate_grad(
            bf16, V, dx.data_ptr(), den.data_ptr(), num.data_ptr(), e_hat.data_ptr(),
            b_j.data_ptr(), de_new.data_ptr() if bn else None, emask.data_ptr(),
            stats.data_ptr() if bn else None, kk.data_ptr() if bn else None,
            ptr(keep), scale, dt.data_ptr(), db_j.data_ptr(), dd.data_ptr(), R, D, W,
            GATE_EPS, s)
        check_launch(_LIB, rc, "gated_edge_gate_grad")
        gated_edge_backward.launches += 1
    return dt, db_j, dd, dg, db


gated_edge_backward.launches = 0


class GatedEdge(torch.autograd.Function):
    """(x, e') of the block (module doc) through the kernels, with eW = e @
    w_c and the gradients' GEMMs in torch (cuBLAS)."""

    @staticmethod
    def forward(ctx, e, w_c, e_j, b_j, d, a, g, b, emask, count, bn, train, drop):
        ew = e @ w_c
        x, e_new, (e_hat, den, num, stats) = gated_edge_forward(
            ew, e_j, b_j, d, a, emask, e, bn, count, train, drop=drop)
        ctx.train = train
        ctx.rate = None if drop is None else drop[1]
        keep = None if drop is None else drop[0]
        ctx.save_for_backward(e, w_c, e_hat, b_j, emask, den, num, stats, g, count,
                              keep)
        return x, e_new

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dx, de_new):
        e, w_c, e_hat, b_j, emask, den, num, stats, g, count, keep = ctx.saved_tensors
        if de_new is not None:
            de_new = de_new.contiguous()
        dt, db_j, dd, dg, db = gated_edge_backward(
            dx.contiguous(), de_new, e_hat, b_j, emask, den, num, stats, g, count,
            ctx.train, None if keep is None else (keep, ctx.rate))
        W = w_c.shape[0]
        flat = dt.view(-1, W)
        de = (flat @ w_c.t() if de_new is None
              else torch.addmm(de_new.view(-1, W), flat, w_c.t()))
        dw_c = e.reshape(-1, W).t() @ flat
        return (de.view(e.shape), dw_c, dt, db_j, dd, dx, dg, db, None, None, None,
                None, None)


def gated_edge(e, w_c, e_j, b_j, d, a, emask, pad_slots, bn, count, train: bool,
               drop=None):
    """(x, e' or None) as gated_edge_plain (its arguments): the plain version
    for a CPU tensor, else the kernels (GatedEdge when a gradient is
    needed)."""
    if e.device.type == "cpu":
        return gated_edge_plain(e, w_c, e_j, b_j, d, a, emask, pad_slots, bn, count,
                                train, drop)
    e, e_j, b_j, d, a = (t.contiguous() for t in (e, e_j, b_j, d, a))
    g, b = (None, None) if bn is None else (bn.g, bn.b)
    inputs = (e, w_c, e_j, b_j, d, a, g, b)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return GatedEdge.apply(*inputs, emask, count, bn, train, drop)
    x, e_new, _ = gated_edge_forward(e @ w_c, e_j, b_j, d, a, emask, e, bn, count,
                                     train, save=False, drop=drop)
    return x, e_new
