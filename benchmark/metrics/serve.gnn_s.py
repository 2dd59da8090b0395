"""The GNN a request (models/, its kernels, the voxel gather and the axis
masks): stage_times gnn_forward; mean over the requests."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "gnn_forward")
