"""GraphGPS's global attention (models/gps.py): torch's
scaled_dot_product_attention over [B, H, N, P], the head width F padded to
P, flash kernels in bfloat16, the memory-efficient (CUTLASS) ones in
float32. A launch's floor is the larger of its tensor-core FLOPs on the
real query-key pairs (n^2 a graph and head: a change that skips padding
reads better) over the precision's peak, and its bytes over HBM bandwidth:
Q, K, V and O (and the row log-sum-exp) forward; those, dO, and dQ, dK, dV
backward, each at its launched shape once. The forward is 4 F flops a pair
(scores and weighted sum), the backward 10 F (the scores recomputed, dV,
dP, dQ and dK). The softmax's exponentials (the SFU: 16 a clock an SM) are
not in the floor: they can move off that unit."""

from __future__ import annotations

from ..peaks import HBM_BYTES_PER_S, flops_peak

# kernels of the attention (names contain one of these) and of its forward
KERNELS = ("flash_fwd", "flash_bwd", "fmha_cutlass")
FORWARD = ("flash_fwd_kernel", "fmha_cutlassF")


def real_pairs(shapes: dict) -> float:
    """Query-key pairs between real nodes a head: B graphs of live / B real
    nodes each (the cell's graphs are all of one size)."""
    n = shapes["live"] / shapes["B"]
    return shapes["B"] * n * n


def forward_bytes(B, N, H, P, es) -> int:
    return 4 * B * N * H * P * es + B * H * N * 4


def backward_bytes(B, N, H, P, es) -> int:
    return 8 * B * N * H * P * es + B * H * N * 4


def step_bound_s(shapes: dict, layers: int, width: int, heads: int,
                 precision: str) -> float:
    """Least time of one training step's attention: a forward and a
    backward per layer."""
    B, N, es = shapes["B"], shapes["N"], shapes["es"]
    F = width // heads
    P = (F // 8 + 1) * 8
    peak = flops_peak(precision)
    pairs = real_pairs(shapes) * heads
    fwd = max(4.0 * F * pairs / peak, forward_bytes(B, N, heads, P, es) / HBM_BYTES_PER_S)
    bwd = max(10.0 * F * pairs / peak,
              backward_bytes(B, N, heads, P, es) / HBM_BYTES_PER_S)
    return layers * (fwd + bwd)
