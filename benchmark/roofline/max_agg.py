"""max_agg_kernel (max aggregation, winner slot stored for training) and
max_agg_bwd_kernel (its gradient through the winner and reciprocal slots),
over an ELL table [B, N, D] of int32 slots with a float32 mask, features
F wide of `es` bytes. `referenced`: the distinct real rows any real slot
names. Byte counts as chip_smoke.py's timing phases count them."""

from __future__ import annotations

from ..peaks import HBM_BYTES_PER_S

KERNELS = ("max_agg_kernel", "max_agg_bwd_kernel")


def forward_bytes(B, N, D, F, es, referenced, store_arg=True) -> int:
    table = B * N * D * 4
    return referenced * F * es + 2 * table + B * N * F * (es + (1 if store_arg else 0))


def backward_bytes(B, N, D, F, es, referenced) -> int:
    table = B * N * D * 4
    return referenced * F * (es + 1) + 3 * table + B * N * F * es


def bound_s(nbytes: int, flops: float = 0.0, flops_peak: float = float("inf")) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_peak)


def step_bound_s(shapes: dict, widths: list[int]) -> float:
    """Least time of one training step's launches: a forward and a backward
    for each SAGE-pool layer's input width (the pooled features)."""
    B, N, D, es, ref = (shapes[k] for k in ("B", "N", "D", "es", "referenced"))
    total = 0.0
    for F in widths:
        total += bound_s(forward_bytes(B, N, D, F, es, ref))
        total += bound_s(backward_bytes(B, N, D, F, es, ref))
    return total
