"""Host preprocessing a request (data/nifti, data/image, data/slic,
data/graph_build): stage_times nifti_read + normalize + graph_build, less
slic_device where the chain runs on the card; mean over the requests."""

from benchmark.records import stage_mean


def read(record, cell):
    prep = stage_mean(record, "nifti_read", "normalize", "graph_build")
    if prep is None:
        return None
    return prep - (stage_mean(record, "slic_device") or 0.0)
