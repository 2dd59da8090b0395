"""Crop and CNN a request (cli/common.py, models/refine_cnn.py):
stage_times crop_and_prep + cnn_forward; mean over the requests."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "crop_and_prep", "cnn_forward")
