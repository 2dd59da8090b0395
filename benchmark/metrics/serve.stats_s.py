"""Segment statistics a request (data/graph_build.sample_from_partition:
quantiles, mode, centroids and the empty-supervoxel discard): stage_times
stats, from the program's span serve.stats; mean over the untraced
requests. Nothing where the program has no such stage."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "stats")
