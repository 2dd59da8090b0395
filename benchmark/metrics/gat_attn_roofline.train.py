"""gat_fwd_kernel, gat_bwd_kernel and gat_rev_kernel in the traced epoch:
their least time on the card (roofline/gat_attn.py, per GAT layer a
forward, a backward and a reverse combine) over their measured device
time, in percent. Nothing where they do not run."""

from benchmark.records import kernel_time
from benchmark.roofline import gat_attn
from benchmark.weights import gat_layers


def read(record, cell):
    t = record.get("trace")
    if record.get("kind") != "train" or not t:
        return None
    cfg = record["config"]
    layers = gat_layers(cfg["in_feats"], cfg["layer_sizes"], cfg["gat_heads"],
                        cfg["gat_residuals"], cfg["out_classes"])
    s, _ = kernel_time(t, *gat_attn.KERNELS)
    _, fwd_n = kernel_time(t, "gat_fwd_kernel")
    if not fwd_n or s <= 0:
        return None
    steps = fwd_n / len(layers)
    return 100.0 * steps * gat_attn.step_bound_s(record["shapes"], layers) / s
