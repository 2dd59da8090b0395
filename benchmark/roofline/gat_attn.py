"""The fused GAT kernels: gat_fwd_kernel (softmax over a row's slots, the
weighted sum of z, bias, residual and ELU; alpha and the sign mask stored
for training), gat_bwd_kernel (the softmax backward to el and er) and
gat_rev_kernel (the reverse combine to z through the reciprocal slots),
over an ELL table [B, N, D] with H heads of F features of `es` bytes.
`referenced`: distinct real rows any real slot names; `live`: rows with a
real slot. Byte counts as chip_smoke.py's timing phases count them."""

from __future__ import annotations

from ..peaks import HBM_BYTES_PER_S

KERNELS = ("gat_fwd_kernel", "gat_bwd_kernel", "gat_rev_kernel")


def forward_bytes(B, N, D, H, F, es, referenced, residual=False, save=True) -> int:
    hf, table, slot = H * F, B * N * D * 4, B * N * D * H
    read = referenced * hf * es + 2 * B * N * H * es + 2 * table + hf * es
    read += B * N * hf * es if residual else 0
    return read + B * N * hf * es + (slot * 5 if save else 0)


def backward_bytes(B, N, D, H, F, es, referenced, live) -> int:
    hf, table, slot = H * F, B * N * D * 4, B * N * D * H
    return (live * hf * es + referenced * hf * es + slot * 5 + 2 * table
            + slot * 4 + B * N * H * 4)


def reverse_bytes(B, N, D, H, F, es, referenced) -> int:
    hf, table, slot = H * F, B * N * D * 4, B * N * D * H
    return referenced * hf * es + slot * 8 + 3 * table + B * N * hf * es + B * N * H * 4


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def step_bound_s(shapes: dict, layers) -> float:
    """Least time of one training step's launches: per GAT layer (in, out,
    heads, residual) a forward, a backward and a reverse combine."""
    B, N, D, es = (shapes[k] for k in ("B", "N", "D", "es"))
    ref, live = shapes["referenced"], shapes["live"]
    total = 0.0
    for fi, fo, h, res in layers:
        total += bound_s(forward_bytes(B, N, D, h, fo, es, ref, residual=res))
        total += bound_s(backward_bytes(B, N, D, h, fo, es, ref, live))
        total += bound_s(reverse_bytes(B, N, D, h, fo, es, ref))
    return total
