"""Device resolution shared by the port's entry points, and the host
allocator setting of the preprocessing pipeline (a copy of
gnn_tumor_seg_tpu/runtime.py's `enable_host_alloc_reuse`)."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "enable_host_alloc_reuse"]

_alloc_reuse_enabled = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks for
    the CPU. Raises when a CUDA device is asked for and none is present; the
    port never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def enable_host_alloc_reuse() -> bool:
    """Keep large host allocations in the glibc heap instead of mmap/munmap.

    glibc serves every allocation over M_MMAP_THRESHOLD (128 KB) with a fresh
    mmap and munmaps it on free, so each per-sample numpy volume (~80-140 MB
    in preprocessing) pays its first-touch page faults again every sample.
    mallopt(M_MMAP_MAX, 0) and a huge trim threshold route large blocks
    through the sbrk heap and never return them to the OS, so pages fault
    once per size class per process instead of once per sample.

    Also pins M_ARENA_MAX=1: glibc worker-thread arenas are 64 MB-capped
    sub-heaps, so >64 MB buffers allocated from loader threads would still
    mmap/munmap per sample; one shared main arena serves any size from brk.
    Call it before spawning worker threads.

    Trade-off: RSS stays at the high-water mark (the heap never shrinks).
    Call it from throughput-bound host pipelines (preprocessing), not from
    short-lived tools that care about peak RSS. A no-op without glibc;
    returns whether the settings took."""
    global _alloc_reuse_enabled
    if _alloc_reuse_enabled:
        return True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:
        return False
    M_TRIM_THRESHOLD, M_MMAP_MAX, M_ARENA_MAX = -1, -4, -8
    ok = bool(libc.mallopt(M_ARENA_MAX, 1))
    ok = bool(libc.mallopt(M_MMAP_MAX, 0)) and ok
    ok = bool(libc.mallopt(M_TRIM_THRESHOLD, ctypes.c_int(2 ** 31 - 1))) and ok
    _alloc_reuse_enabled = ok
    return ok
