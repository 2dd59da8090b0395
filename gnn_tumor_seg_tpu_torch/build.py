"""Build the port's shared libraries at first use.

The host C++ kernels (native/gts_native.cc, with g++) and the CUDA kernels
(ops/kernels/csrc/*.cu, with nvcc for sm_90a) compile into BUILD_DIR, which
git ignores. A library's file name carries a hash of its sources and its
command line, so an edited source is rebuilt and a stale library is never
loaded. The compiler writes to a temporary name that is renamed into place,
so processes that build the same library at once never load a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

__all__ = ["BUILD_DIR", "build_library", "build_cuda_library", "nvcc_path",
           "check_launch", "build_all"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
# sm_90a (Hopper with its architecture-specific features), a plain C
# interface, and ptxas' register and shared-memory report in the build log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def build_library(stem: str, sources: list[str],
                  command: list[str]) -> tuple[str, str]:
    """Compile `sources` with `command` (compiler and flags, without the
    output and source arguments) into BUILD_DIR/<stem>-<hash>.so.

    Returns (library path, compiler output); the output is empty when the
    library was already built. Raises RuntimeError when the compiler fails."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{stem}-", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([*command, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {stem} failed ({' '.join(command)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the port's CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_cuda_library(stem: str, source: str) -> tuple[ctypes.CDLL, str]:
    """Compile one kernel source (ops/kernels/csrc/*.cu) with nvcc and load
    it. Every source exports `gts_cuda_error_string`, which check_launch
    reads. Returns (library, nvcc's output)."""
    path, log = build_library(stem, [source], [nvcc_path(), *NVCC_FLAGS])
    lib = ctypes.CDLL(path)
    lib.gts_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gts_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code (its
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.gts_cuda_error_string(rc).decode()}")


def build_all(cuda: bool = True) -> dict[str, tuple[str, float]]:
    """Build the native host library and, with `cuda`, the seven kernel
    libraries, one compiler process each, all started together. Returns
    {library: (compiler output, seconds)}; raises on the first failure."""
    import concurrent.futures
    import time

    from .data import native
    from .ops.kernels import (fused_gat, gated_edge, graph_attn, max_agg, slot_gather,
                              sum_agg, weighted_sum)

    jobs = {"gts_native.cc (g++)": native.build}
    if cuda:
        jobs.update({f"{mod.__name__.rsplit('.', 1)[1]}.cu (nvcc sm_90a)": mod.build
                     for mod in (max_agg, sum_agg, fused_gat, weighted_sum,
                                 slot_gather, graph_attn, gated_edge)})

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        return {name: fut.result() for name, fut in futures.items()}
