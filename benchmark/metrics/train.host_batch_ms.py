"""Host milliseconds a training step in batch assembly (train/gnn_trainer.py:
device-cache lookups, uploads on a miss, remainder padding and
ops/graph.batch_graphs): the program's span train.batch (last_epoch_stats
host_s.batch) over the steps of the window's untraced epochs. Nothing
where the program has no such span."""

from benchmark.program_spans import host_ms_per_step


def read(record, cell):
    return host_ms_per_step(record, "batch")
