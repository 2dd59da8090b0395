"""GraphGPS's attention kernels in the traced epoch: their least time on
the card (roofline/gps_attn.py, per GPS layer a forward and a backward,
FLOPs on real pairs or bytes, whichever bounds) over their measured device
time, in percent. Nothing where they do not run."""

from benchmark.records import kernel_time
from benchmark.roofline import gps_attn


def read(record, cell):
    t = record.get("trace")
    if record.get("kind") != "train" or not t:
        return None
    cfg = record["config"]
    if "gps_heads" not in cfg:
        return None
    layers = len(cfg["layer_sizes"])
    s, _ = kernel_time(t, *gps_attn.KERNELS)
    _, fwd_n = kernel_time(t, *gps_attn.FORWARD)
    if not fwd_n or s <= 0:
        return None
    steps = fwd_n / layers
    bound = gps_attn.step_bound_s(record["shapes"], layers, cfg["layer_sizes"][0],
                                  cfg["gps_heads"], record["precision"])
    return 100.0 * steps * bound / s
