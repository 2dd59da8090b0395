"""Host milliseconds a training step in the forward launches (the model and
weighted_cross_entropy): the program's span train.forward
(last_epoch_stats host_s.forward) over the steps of the window's untraced
epochs. Nothing where the program has no such span."""

from benchmark.program_spans import host_ms_per_step


def read(record, cell):
    return host_ms_per_step(record, "forward")
