"""Device milliseconds a training step in kernels that are not the port's
own (GEMMs, elementwise, loss, AdamW), over the traced epoch's steps."""

from benchmark.records import PORT_KERNELS, is_copy


def read(record, cell):
    t = record.get("trace")
    if record.get("kind") != "train" or not t:
        return None
    steps = sum(e["steps"] for e in record["epochs"] if e.get("traced"))
    if not steps:
        return None
    s = sum(v for k, v in t["kernel_s"].items()
            if not is_copy(k) and not any(p in k for p in PORT_KERNELS))
    return 1e3 * s / steps
