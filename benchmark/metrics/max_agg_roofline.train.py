"""max_agg_kernel and max_agg_bwd_kernel in the traced epoch: their least
time on the card (roofline/max_agg.py, a forward and a backward per
SAGE-pool layer at its pooled width) over their measured device time, in
percent. Nothing where they do not run."""

from benchmark.records import kernel_time
from benchmark.roofline import max_agg


def read(record, cell):
    t = record.get("trace")
    if record.get("kind") != "train" or not t:
        return None
    cfg = record["config"]
    widths = [cfg["in_feats"], *cfg["layer_sizes"]]
    fwd_s, fwd_n = kernel_time(t, "max_agg_kernel")
    bwd_s, _ = kernel_time(t, "max_agg_bwd_kernel")
    if not fwd_n or fwd_s + bwd_s <= 0:
        return None
    steps = fwd_n / len(widths)
    return 100.0 * steps * max_agg.step_bound_s(record["shapes"], widths) / (fwd_s + bwd_s)
