"""slot_gather_kernel (each slot's neighbour row: out[b,v,d] =
x[b, nbr[b,v,d]]) and slot_gather_bwd_kernel (its gradient, gout read
through the reciprocal slots), over an ELL table [B, N, D] of int32 slots
with a float32 mask and rows W wide of `es` bytes. Byte counts as
chip_smoke.py's timing phases count them (PERF.md §6 row 9): forward the
referenced rows, the table twice (slots and mask) and the output;
backward gout on the real slots, three tables (slots, mask, rslot) and
the gradient."""

from __future__ import annotations

from ..peaks import HBM_BYTES_PER_S

KERNELS = ("slot_gather_kernel", "slot_gather_bwd_kernel")


def forward_bytes(B, N, D, W, es, referenced) -> int:
    table = B * N * D * 4
    return referenced * W * es + 2 * table + B * N * D * W * es


def backward_bytes(B, N, D, W, es, real) -> int:
    table = B * N * D * 4
    return real * W * es + 3 * table + B * N * W * es


def step_bound_s(shapes: dict, launches, real_slots: float) -> float:
    """Least time of one step's launches, each (W, es, backward): a
    forward, and with backward its gradient too; `real_slots` the step's
    real slots (edges)."""
    B, N, D, ref = (shapes[k] for k in ("B", "N", "D", "referenced"))
    total = 0.0
    for W, es, backward in launches:
        total += forward_bytes(B, N, D, W, es, ref)
        if backward:
            total += backward_bytes(B, N, D, W, es, real_slots)
    return total / HBM_BYTES_PER_S
