"""The whole request's share of the card's peak, in percent: analytic
FLOPs of the GNN forward (real nodes and edges x layer widths) and of the
CNN forward (its input crop's voxels x convolution widths), summed over
the untraced requests, over their wall time x the peak of the cell's
precision."""

from benchmark import flops
from benchmark.peaks import flops_peak
from benchmark.records import untraced


def read(record, cell):
    if record.get("kind") != "serve":
        return None
    reqs = [r for r in untraced(record["requests"]) if "cnn_voxels" in r]
    if not reqs:
        return None
    cfg = record["config"]
    work = sum(flops.gnn_forward(cfg, r["n_nodes"], r["n_edges"])
               + flops.cnn_forward(cfg["cnn"], r["cnn_voxels"]) for r in reqs)
    wall = sum(r["wall"] for r in reqs)
    return 100.0 * work / (wall * flops_peak(record["precision"]))
