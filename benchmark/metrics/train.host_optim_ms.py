"""Host milliseconds a training step in AdamW (zero_grad and optimizer.step):
the program's span train.optim (last_epoch_stats host_s.optim) over the
steps of the window's untraced epochs. Nothing where the program has no
such span."""

from benchmark.program_spans import host_ms_per_step


def read(record, cell):
    return host_ms_per_step(record, "optim")
