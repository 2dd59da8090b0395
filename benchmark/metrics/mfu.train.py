"""The whole training step's share of the card's peak, in percent:
analytic forward and backward FLOPs of a step on its real nodes and
edges, times the steps of the untraced epochs, over their wall time x
the peak of the cell's precision."""

from benchmark.peaks import flops_peak
from benchmark.records import untraced


def read(record, cell):
    if record.get("kind") != "train":
        return None
    epochs = untraced(record["epochs"])
    steps = sum(e["steps"] for e in epochs)
    wall = sum(e["wall"] for e in epochs)
    if not steps or wall <= 0:
        return None
    return 100.0 * steps * record["step_flops"] / (wall * flops_peak(record["precision"]))
