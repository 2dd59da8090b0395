"""Share of the attention's query-key pairs that involve padding, in
percent: 1 - attn_real_pairs / attn_pairs, the program's counters
(last_epoch_stats, models/gps.py step_counts) over the window's untraced
epochs. Nothing where the program keeps no such counters."""

from benchmark.program_spans import window_epochs


def read(record, cell):
    epochs = window_epochs(record)
    if not epochs or not all("attn_pairs" in e for e in epochs):
        return None
    pairs = sum(e["attn_pairs"] for e in epochs)
    if not pairs:
        return None
    return 100.0 * (1.0 - sum(e["attn_real_pairs"] for e in epochs) / pairs)
