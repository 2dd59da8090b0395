"""Device preprocessing a request (ops/slic_device.py): stage_times
slic_device, the chain from the raw crop's upload to the SLIC cells on
the host; mean over the requests. Nothing where the chain does not run."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "slic_device")
