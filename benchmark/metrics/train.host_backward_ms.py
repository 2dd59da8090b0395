"""Host milliseconds a training step in autograd's backward
(loss.backward()): the program's span train.backward (last_epoch_stats
host_s.backward) over the steps of the window's untraced epochs. Nothing
where the program has no such span."""

from benchmark.program_spans import host_ms_per_step


def read(record, cell):
    return host_ms_per_step(record, "backward")
