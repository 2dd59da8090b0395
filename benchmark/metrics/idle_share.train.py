"""Share of the traced epoch's wall time in which no kernel, copy or
memset ran on the device, in percent."""

from benchmark.records import idle_percent


def read(record, cell):
    return idle_percent(record) if record.get("kind") == "train" else None
