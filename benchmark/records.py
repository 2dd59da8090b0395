"""What the per-layer metrics' readers share: the units of a run's record
(requests or epochs) outside the traced region, stage means, and the
device time of the port's kernels by name in the trace."""

from __future__ import annotations

# the port's own CUDA kernels (gnn_tumor_seg_tpu_torch/ops/kernels/csrc)
PORT_KERNELS = ("max_agg_kernel", "max_agg_bwd_kernel", "sum_agg_kernel",
                "gat_fwd_kernel", "gat_bwd_kernel", "gat_rev_kernel",
                "wsum_kernel", "pairdot_kernel", "slot_gather_kernel",
                "slot_gather_bwd_kernel")


def untraced(units: list[dict]) -> list[dict]:
    """The units that ran outside the profiler, or all where none did."""
    rest = [u for u in units if not u.get("traced")]
    return rest or list(units)


def stage_mean(record: dict, *stages: str) -> float | None:
    """Mean over the window's requests of the sum of `stages` of each
    request's stage_times; None where no request has them."""
    reqs = [r for r in untraced(record.get("requests", [])) if r.get("stages")]
    if not reqs or not any(s in reqs[0]["stages"] for s in stages):
        return None
    return sum(sum(r["stages"].get(s, 0.0) for s in stages) for r in reqs) / len(reqs)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def kernel_time(trace: dict, *names: str) -> tuple[float, int]:
    """Seconds and launches in the trace of kernels whose name contains one
    of `names` (kernel names carry template arguments)."""
    s = n = 0
    for k, v in trace["kernel_s"].items():
        if any(x in k for x in names):
            s += v
            n += trace["kernel_n"][k]
    return s, n


def idle_percent(record: dict) -> float | None:
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
