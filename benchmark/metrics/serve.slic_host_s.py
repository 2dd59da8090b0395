"""Host SLIC a request (data/graph_build.build_graph_sample's SLIC call with
its connectivity pass): stage_times slic_host, from the program's span
serve.slic_host; mean over the untraced requests. Nothing where the
program has no such stage."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "slic_host")
