"""ctypes bindings to the native C++ preprocessing kernels (native/gts_native.cc).

Counterpart of gnn_tumor_seg_tpu/data/native.py. The library is compiled with
g++ from the repository's native/gts_native.cc into the port's own build
directory (gnn_tumor_seg_tpu_torch/build.py) at first use; the tracked
native/libgts_native.so is never read or written. The flags are those of
native/build.py, so both packages compute the same partitions and features.

`available()` is False when g++ or the compile fails, and the "auto" callers
(data/slic.py, data/graph_build.py) then take their numpy paths; `build()`
raises instead, for callers that require the native path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..build import build_library

__all__ = ["available", "build", "slic3d_native", "segment_quantiles_native",
           "segment_mode_native", "segment_centroids_native",
           "enforce_connectivity_native", "knn_regular_native"]

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "gts_native.cc")
_COMMAND = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-fopenmp"]

_LIB = None
_FAILED = False


def build() -> str:
    """Compile (if needed) and load the library; returns the compiler output.
    Raises when the library cannot be built or loaded."""
    global _LIB
    path, log = build_library("gts_native", [_SOURCE], _COMMAND)
    lib = ctypes.CDLL(path)
    i32, i64, f32p, f64p, i16p, i32p = (
        ctypes.c_int32, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.int16, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
    )
    lib.segment_quantiles.argtypes = [f32p, i32p, i64, i32, f64p, i32, f32p]
    lib.segment_quantiles.restype = None
    lib.segment_mode_u16.argtypes = [i16p, i32p, i64, i32, i32, i32p]
    lib.segment_mode_u16.restype = None
    lib.segment_centroids.argtypes = [i32p, i64, i64, i64, i32, f32p]
    lib.segment_centroids.restype = None
    lib.slic3d.argtypes = [f32p, i64, i64, i64, i64, i32, i32, i32,
                           ctypes.c_double, ctypes.c_double, i32, i32p]
    lib.slic3d.restype = None
    lib.enforce_connectivity.argtypes = [i32p, i64, i64, i64, i32]
    lib.enforce_connectivity.restype = None
    lib.knn_regular.argtypes = [f32p, i64, i32, i32p, i32p, i64]
    lib.knn_regular.restype = ctypes.c_int64
    _LIB = lib
    return log


def _lib():
    global _FAILED
    if _LIB is None and not _FAILED:
        try:
            build()
        except (OSError, RuntimeError):     # no g++, a failed compile or load
            _FAILED = True
    return _LIB


def available() -> bool:
    return _lib() is not None


def segment_quantiles_native(values: np.ndarray, segs: np.ndarray, n_seg: int,
                             quantiles) -> np.ndarray:
    lib = _lib()
    values = np.ascontiguousarray(values, np.float32)
    segs = np.ascontiguousarray(segs, np.int32)
    qs = np.ascontiguousarray(quantiles, np.float64)
    out = np.empty((n_seg, len(qs)), np.float32)
    lib.segment_quantiles(values, segs, values.size, n_seg, qs, len(qs), out)
    return out


def segment_mode_native(labels: np.ndarray, segs: np.ndarray, n_seg: int,
                        n_vals: int) -> np.ndarray:
    lib = _lib()
    labels = np.ascontiguousarray(labels, np.int16)
    segs = np.ascontiguousarray(segs, np.int32)
    out = np.empty(n_seg, np.int32)
    lib.segment_mode_u16(labels, segs, labels.size, n_seg, n_vals, out)
    return out


def segment_centroids_native(segs_volume: np.ndarray, n_seg: int) -> np.ndarray:
    lib = _lib()
    segs_volume = np.ascontiguousarray(segs_volume, np.int32)
    X, Y, Z = segs_volume.shape
    out = np.empty((n_seg, 3), np.float32)
    lib.segment_centroids(segs_volume.reshape(-1), X, Y, Z, n_seg, out)
    return out


def slic3d_native(image: np.ndarray, gx: int, gy: int, gz: int,
                  compactness: float, step: float, iters: int) -> np.ndarray:
    lib = _lib()
    image = np.ascontiguousarray(image, np.float32)
    X, Y, Z, C = image.shape
    out = np.empty(X * Y * Z, np.int32)
    inv_m2 = 1.0 / max(compactness, 1e-8) ** 2
    inv_s2 = 1.0 / step ** 2
    lib.slic3d(image.reshape(-1), X, Y, Z, C, gx, gy, gz, inv_m2, inv_s2,
               iters, out)
    return out.reshape(X, Y, Z)


def knn_regular_native(centroids: np.ndarray, k: int):
    """Greedy symmetric k-regular kNN edges; same semantics as the numpy
    knn_adjacency_edges(enforce_regularity=True)."""
    lib = _lib()
    centroids = np.ascontiguousarray(centroids, np.float32)
    n = len(centroids)
    cap = 4 * n * (k + 8)
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    written = lib.knn_regular(centroids, n, k, src, dst, cap)
    if written < 0:
        raise RuntimeError("knn_regular edge buffer overflow")
    return src[:written].copy(), dst[:written].copy()


def enforce_connectivity_native(labels: np.ndarray) -> np.ndarray:
    lib = _lib()
    labels = np.ascontiguousarray(labels, np.int32).copy()
    X, Y, Z = labels.shape
    n_labels = int(labels.max()) + 1
    lib.enforce_connectivity(labels.reshape(-1), X, Y, Z, n_labels)
    return labels
