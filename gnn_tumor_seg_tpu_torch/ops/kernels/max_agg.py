"""Max aggregation with first-winner slots: the Hopper kernel and its plain version.

Replaces gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:135 `_max_kernel`
(launched by `tiled_aggregate_max_fwd`, gather_agg.py:166). The kernel is
CUDA C++ (csrc/max_agg.cu), built for sm_90a with nvcc into a shared library
with a plain C interface at first use and loaded with ctypes; its header says
what bounds it (bytes) and what the design does about that.

`max_aggregate` launches the kernel on a CUDA tensor and takes the plain
version, `max_aggregate_plain`, only for a CPU tensor. On a CUDA tensor it
launches the kernel or raises; it never falls back. `max_aggregate.launches`
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...build import build_library

__all__ = ["max_aggregate", "max_aggregate_plain", "build", "nvcc_path"]

_NEG_LARGE = -1e30
_MAX_DEGREE = 128
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "max_agg.cu")
_COMMAND = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIB = None


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the max-aggregation kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile (if needed) and load the kernel library; returns nvcc's output
    (with ptxas' register and shared-memory report)."""
    global _LIB
    path, log = build_library("max_agg", [_SOURCE], [nvcc_path(), *_COMMAND])
    lib = ctypes.CDLL(path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gts_max_agg_f32, lib.gts_max_agg_bf16):
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
        fn.restype = i32
    lib.gts_cuda_error_string.argtypes = [i32]
    lib.gts_cuda_error_string.restype = ctypes.c_char_p
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


def _check(h, nbr, nbr_mask):
    if h.dim() != 3 or nbr.dim() != 3 or nbr.shape != nbr_mask.shape \
            or nbr.shape[:2] != h.shape[:2]:
        raise ValueError(f"expected h [B,N,F] and nbr, nbr_mask [B,N,D]; got "
                         f"{tuple(h.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(nbr_mask.shape)}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if nbr.dtype != torch.int32 or nbr_mask.dtype != torch.float32:
        raise TypeError(f"nbr must be int32 and nbr_mask float32, got "
                        f"{nbr.dtype}, {nbr_mask.dtype}")
    if h.device.type != "cuda" or not (nbr.device == nbr_mask.device == h.device):
        raise ValueError("h, nbr and nbr_mask must be on one CUDA device")
    if not (h.is_contiguous() and nbr.is_contiguous()
            and nbr_mask.is_contiguous()):
        raise ValueError("h, nbr and nbr_mask must be contiguous")
    if not 1 <= nbr.shape[2] <= _MAX_DEGREE:
        raise ValueError(f"degree padding must be in [1, {_MAX_DEGREE}], "
                         f"got {nbr.shape[2]}")
    if torch.is_grad_enabled() and h.requires_grad:
        raise NotImplementedError(
            "the max-aggregation kernel has no backward yet (the training "
            "slice ports gather_agg._max_bwd_kernel; see ROADMAP.md)")


def max_aggregate(h: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor,
                  with_arg: bool = True):
    """(out, arg) as max_aggregate_plain; arg is None when with_arg is False
    (the serve path, which discards it: the kernel then skips its store).

    nbr's real slots must index rows of h (ops/graph.ell_from_edges checks
    this when it builds the table)."""
    if h.device.type == "cpu":
        out, arg = max_aggregate_plain(h, nbr, nbr_mask)
        return out, (arg if with_arg else None)
    _check(h, nbr, nbr_mask)
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
    if rc != 0:
        raise RuntimeError(f"max_agg kernel launch failed: "
                           f"{_LIB.gts_cuda_error_string(rc).decode()}")
    max_aggregate.launches += 1
    return out, arg


max_aggregate.launches = 0
