"""The regular kNN a request (data/graph_build.knn_adjacency_edges):
stage_times knn, from the program's span serve.knn; mean over the untraced
requests. Nothing where the program has no such stage."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "knn")
