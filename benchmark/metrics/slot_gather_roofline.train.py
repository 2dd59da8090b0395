"""slot_gather_kernel and slot_gather_bwd_kernel in the traced epoch of a
GraphGPS cell: their least time on the card (roofline/slot_gather.py) over
their measured device time, in percent. A step gathers the float32 input
features once (the edge encoder's, no gradient) and, per GPS layer, the
rows of B h and of E h, W wide in the compute dtype, forward and
backward. The
step's real slots are the trainer's edge count (last_epoch_stats:
edges_per_s x seconds over the layers and steps). Nothing where the
kernels do not run or the program keeps no edge count."""

from benchmark.program_spans import window_epochs
from benchmark.records import kernel_time
from benchmark.roofline import slot_gather


def read(record, cell):
    t = record.get("trace")
    if record.get("kind") != "train" or not t:
        return None
    cfg = record["config"]
    if "gps_heads" not in cfg:
        return None
    layers = len(cfg["layer_sizes"])
    fwd_s, _ = kernel_time(t, "slot_gather_kernel")
    bwd_s, bwd_n = kernel_time(t, "slot_gather_bwd_kernel")
    epochs = window_epochs(record)
    if not bwd_n or fwd_s + bwd_s <= 0 or not epochs:
        return None
    e = epochs[0]
    if not e.get("steps") or "edges_per_s" not in e:
        return None
    real = e["edges_per_s"] * e["seconds"] / layers / e["steps"]
    es = record["shapes"]["es"]
    launches = ([(cfg["in_feats"], 4, False)]
                + [(cfg["layer_sizes"][0], es, True)] * (2 * layers))
    steps = bwd_n / (2 * layers)
    return (100.0 * steps * slot_gather.step_bound_s(record["shapes"], launches, real)
            / (fwd_s + bwd_s))
