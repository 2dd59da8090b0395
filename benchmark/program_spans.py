"""What the readers of the program's own spans share
(gnn_tumor_seg_tpu_torch/spans.py): the window's training epochs as the
trainer recorded them. A program without the module, or without the
totals, gives nothing to read."""

from __future__ import annotations


def window_epochs(record: dict) -> list[dict] | None:
    """The trainer's stats of the window's epochs (recent("train.epoch"),
    the last len(record["epochs"]); set-up's epoch comes before them): those
    that ran outside the profiler, or all where none did. None where the
    program keeps no such totals."""
    if record.get("kind") != "train" or not record.get("epochs"):
        return None
    try:
        from gnn_tumor_seg_tpu_torch import spans
    except ImportError:
        return None
    epochs = spans.recent("train.epoch")[-len(record["epochs"]):]
    if not epochs or not all("host_s" in e for e in epochs):
        return None
    return [e for e in epochs if not e["profiled"]] or epochs


def host_ms_per_step(record: dict, phase: str) -> float | None:
    """Host milliseconds a step in `phase` of the trainer's host_s, over
    the steps of the window's untraced epochs."""
    epochs = window_epochs(record)
    if not epochs:
        return None
    steps = sum(e["steps"] for e in epochs)
    if not steps:
        return None
    return 1e3 * sum(e["host_s"][phase] for e in epochs) / steps
