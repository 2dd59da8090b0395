"""GraphGPS's global attention over each graph's real nodes: the Hopper
kernels and their plain versions.

Replaces no Pallas kernel: GraphGPS has no JAX counterpart. The kernels
(csrc/graph_attn.cu: `gps_flash_fwd_kernel`, and the backward's
`gps_flash_bwd_prep_kernel`, `gps_flash_bwd_dkdv_kernel` and
`gps_flash_bwd_dq_kernel`) are CUDA C++ built for sm_90a with nvcc into a
shared library with a plain C interface at first use and loaded with ctypes,
as max_agg.cu is. The SFU's exp2 (one a query-key pair, two in the backward)
and the FMA pipe bound them, not the tensor cores or the bytes; the header
of the source says what the design does about that (varlen tiles that stop
at each graph's real-node count, the head width zero-extended in shared
memory, P kept in registers, no atomics).

The attention reads q, k and v in place from the projection qkv [B, N,
3*H*F] (q | k | v, head h at columns h*F of each) and writes att [B, N, H*F];
`counts` [B] int32, on qkv's device, holds each graph's real nodes, which
are its rows 0..n-1. Padded rows of att, and of the gradient, are 0, and a
graph with no real node gives zeros. Head widths 1..32 (MAX_HEAD_WIDTH).

`graph_attn` and `graph_attn_backward` launch their kernels on a CUDA
tensor (bfloat16) and take the plain version only for a CPU tensor; on a
CUDA tensor they launch the kernels or raise, never fall back. Their
`.launches` count kernel launches (one forward, three backward). Both index
with 32-bit integers and raise ValueError when B*N*3*H*F reaches 2**31.
`GraphAttention` is the torch.autograd.Function around both, and
`attention` the differentiable entry.
"""

from __future__ import annotations

import math
import os

import torch

from ...build import build_cuda_library, check_launch
from .fused_gat import _check_like, _check_tensors, _stream

__all__ = ["graph_attn", "graph_attn_plain", "graph_attn_backward",
           "graph_attn_backward_plain", "GraphAttention", "attention",
           "visited_pairs", "build", "MAX_HEAD_WIDTH"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "graph_attn.cu")

MAX_HEAD_WIDTH = 32
# the forward's tiles (csrc/graph_attn.cu kBM and kBN): a graph of n real
# nodes costs ceil(n/128)*128 queries by ceil(n/32)*32 keys a head (the
# backward's 128 by 64 at most 32 keys more)
_TILE_ROWS, _TILE_COLS = 128, 32

_LIB = None


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    import ctypes

    lib, log = build_cuda_library("graph_attn", _SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gts_gps_attn_fwd.argtypes = [vp] * 4 + [i32] * 4 + [f32, vp]
    lib.gts_gps_attn_fwd.restype = i32
    lib.gts_gps_attn_bwd.argtypes = [vp] * 7 + [i32] * 4 + [f32, f32, vp]
    lib.gts_gps_attn_bwd.restype = i32
    _LIB = lib
    return log


def visited_pairs(n: int) -> int:
    """Query-key pairs the forward kernel computes for one head of a graph
    of n real nodes: every pair of the tiles that hold a real row (0 for
    n = 0)."""
    def up(x, tile):
        return -(-x // tile) * tile

    return up(n, _TILE_ROWS) * up(n, _TILE_COLS)


def _dims(qkv: torch.Tensor, counts: torch.Tensor, heads: int) -> tuple[int, int, int]:
    """(B, N, F) of qkv [B, N, 3*heads*F] and counts [B]; raises ValueError
    on other shapes, head widths past MAX_HEAD_WIDTH and 32-bit overflow."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"expected qkv [B, N, 3*H*F] with H = {heads}; got "
                         f"{tuple(qkv.shape)}")
    B, N, C = qkv.shape
    F = C // (3 * heads)
    if not 1 <= F <= MAX_HEAD_WIDTH:
        raise ValueError(f"the attention kernels take head widths 1..{MAX_HEAD_WIDTH}; "
                         f"got {F}")
    if tuple(counts.shape) != (B,):
        raise ValueError(f"counts must be [{B}], got {tuple(counts.shape)}")
    if B * N * C >= 2 ** 31:
        raise ValueError(f"the attention kernels index qkv with 32-bit integers; "
                         f"B*N*3*H*F = {B * N * C} >= 2**31")
    return B, N, F


def _per_graph(qkv, counts, heads):
    """(b, n, q, k, v) of each graph with a real node, q/k/v [n, H, F] in
    float32."""
    B, N, C = qkv.shape
    x = qkv.float().view(B, N, 3, heads, C // (3 * heads))
    for b, n in enumerate(counts.tolist()):
        if n:
            q, k, v = x[b, :n].unbind(1)
            yield b, n, q, k, v


def graph_attn_plain(qkv: torch.Tensor, counts: torch.Tensor, heads: int,
                     save: bool = True):
    """Plain PyTorch version of the forward: qkv [B, N, 3*H*F], counts [B]
    -> (out [B, N, H*F] in qkv's dtype, lse [B, H, N] float32 or None).

    Each graph's attention over its n real nodes in float32: softmax(q k^T /
    sqrt(F)) v; lse is the row log-sum-exp of the scaled scores, +inf on
    padded rows; padded rows of out, and every row of an empty graph, are
    0."""
    B, N, C = qkv.shape
    F = C // (3 * heads)
    out = torch.zeros((B, N, heads * F), dtype=torch.float32, device=qkv.device)
    lse = (torch.full((B, heads, N), math.inf, dtype=torch.float32,
                      device=qkv.device) if save else None)
    for b, n, q, k, v in _per_graph(qkv, counts, heads):
        s = torch.einsum("ihf,jhf->hij", q, k) / math.sqrt(F)
        row = torch.logsumexp(s, -1)
        p = torch.exp(s - row[..., None])
        out[b, :n] = torch.einsum("hij,jhf->ihf", p, v).reshape(n, heads * F)
        if save:
            lse[b, :, :n] = row
    return out.to(qkv.dtype), lse


def graph_attn_backward_plain(qkv, counts, out, lse, gout, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the gradient: the forward's qkv, counts, out
    and lse and gout [B, N, H*F] -> dqkv [B, N, 3*H*F] in qkv's dtype.

    The kernels' arithmetic in float32, a graph at a time over its real
    nodes: p = exp(s / sqrt(F) - lse), dsum = rowsum(gout * out), ds = p
    (gout v^T - dsum), dq = ds k / sqrt(F), dk = ds^T q / sqrt(F), dv = p^T
    gout; padded rows 0."""
    B, N, C = qkv.shape
    F = C // (3 * heads)
    scale = 1.0 / math.sqrt(F)
    dx = torch.zeros((B, N, 3, heads, F), dtype=torch.float32, device=qkv.device)
    for b, n, q, k, v in _per_graph(qkv, counts, heads):
        o = out[b, :n].float().view(n, heads, F)
        go = gout[b, :n].float().view(n, heads, F)
        p = torch.exp(torch.einsum("ihf,jhf->hij", q, k) * scale
                      - lse[b, :, :n, None])
        dsum = (go * o).sum(-1).T
        ds = p * (torch.einsum("ihf,jhf->hij", go, v) - dsum[..., None])
        dx[b, :n, 0] = torch.einsum("hij,jhf->ihf", ds, k) * scale
        dx[b, :n, 1] = torch.einsum("hij,ihf->jhf", ds, q) * scale
        dx[b, :n, 2] = torch.einsum("hij,ihf->jhf", p, go)
    return dx.view(B, N, C).to(qkv.dtype)


def graph_attn(qkv: torch.Tensor, counts: torch.Tensor, heads: int,
               save: bool = True):
    """(out, lse) as graph_attn_plain; lse is None when `save` is False
    (serving and evaluation: the kernel then stores none). Not
    differentiable itself: training goes through GraphAttention."""
    B, N, F = _dims(qkv, counts, heads)
    if qkv.device.type == "cpu":
        return graph_attn_plain(qkv, counts, heads, save)
    if _LIB is None:
        build()
    _check_tensors(qkv.device, [(qkv, "qkv"), (counts, "counts")])
    _check_like(qkv, qkv.shape, torch.bfloat16, "qkv")
    _check_like(counts, (B,), torch.int32, "counts")
    out = torch.empty((B, N, heads * F), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
           if save else None)
    with torch.cuda.device(qkv.device):
        rc = _LIB.gts_gps_attn_fwd(qkv.data_ptr(), counts.data_ptr(),
                                   out.data_ptr(), lse.data_ptr() if save else None,
                                   B, N, heads, F, math.log2(math.e) / math.sqrt(F),
                                   _stream(qkv.device))
    check_launch(_LIB, rc, "gps_flash_fwd")
    graph_attn.launches += 1
    return out, lse


graph_attn.launches = 0


def graph_attn_backward(qkv, counts, out, lse, gout, heads: int) -> torch.Tensor:
    """dqkv as graph_attn_backward_plain: the prep, dK/dV and dQ kernels."""
    B, N, F = _dims(qkv, counts, heads)
    if qkv.device.type == "cpu":
        return graph_attn_backward_plain(qkv, counts, out, lse, gout, heads)
    if _LIB is None:
        build()
    _check_tensors(qkv.device, [(qkv, "qkv"), (counts, "counts"), (out, "out"),
                                (lse, "lse"), (gout, "gout")])
    _check_like(qkv, qkv.shape, torch.bfloat16, "qkv")
    _check_like(counts, (B,), torch.int32, "counts")
    _check_like(out, (B, N, heads * F), torch.bfloat16, "out")
    _check_like(gout, (B, N, heads * F), torch.bfloat16, "gout")
    _check_like(lse, (B, heads, N), torch.float32, "lse")
    dsum = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        rc = _LIB.gts_gps_attn_bwd(qkv.data_ptr(), out.data_ptr(), gout.data_ptr(),
                                   lse.data_ptr(), counts.data_ptr(), dsum.data_ptr(),
                                   dqkv.data_ptr(), B, N, heads, F,
                                   math.log2(math.e) / math.sqrt(F),
                                   1.0 / math.sqrt(F), _stream(qkv.device))
    check_launch(_LIB, rc, "gps_flash_bwd")
    graph_attn_backward.launches += 3
    return dqkv


graph_attn_backward.launches = 0


class GraphAttention(torch.autograd.Function):
    """att = each graph's attention over its real nodes (module doc), with
    the kernels' deterministic backward."""

    @staticmethod
    def forward(ctx, qkv, counts, heads):
        out, lse = graph_attn(qkv, counts, heads)
        ctx.heads = heads
        ctx.save_for_backward(qkv, counts, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        qkv, counts, out, lse = ctx.saved_tensors
        return (graph_attn_backward(qkv, counts, out, lse, gout.contiguous(),
                                    ctx.heads), None, None)


def attention(qkv: torch.Tensor, counts: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv [B, N, 3*H*F] -> att [B, N, H*F]; through GraphAttention when a
    gradient is needed, else the forward without its lse."""
    qkv = qkv.contiguous()
    if torch.is_grad_enabled() and qkv.requires_grad:
        return GraphAttention.apply(qkv, counts, heads)
    return graph_attn(qkv, counts, heads, save=False)[0]
