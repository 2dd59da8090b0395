"""The Hopper kernels of the port and their plain PyTorch versions, one
module each (max_agg, sum_agg, fused_gat, weighted_sum, slot_gather,
graph_attn); every wrapper counts its kernel launches in its `.launches`."""

__all__ = ["launch_counts"]


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count so far in this process (0 for a
    wrapper that a caller has swapped for a function without a count)."""
    from . import fused_gat, graph_attn, max_agg, slot_gather, sum_agg, weighted_sum

    fns = {"max_agg": max_agg.max_aggregate,
           "max_agg_bwd": max_agg.max_aggregate_backward,
           "sum_agg": sum_agg.sum_aggregate,
           "gat_fwd": fused_gat.fused_gat_forward,
           "gat_bwd": fused_gat.fused_gat_backward,
           "gat_rev": fused_gat.gat_reverse_combine,
           "wsum": weighted_sum.weighted_sum,
           "wsum_bwd": weighted_sum.weighted_sum_reverse,
           "pairdot": weighted_sum.pairdot,
           "slot_gather": slot_gather.slot_gather,
           "slot_gather_bwd": slot_gather.slot_gather_backward,
           "gps_attn": graph_attn.graph_attn,
           "gps_attn_bwd": graph_attn.graph_attn_backward}
    return {k: getattr(fn, "launches", 0) for k, fn in fns.items()}
