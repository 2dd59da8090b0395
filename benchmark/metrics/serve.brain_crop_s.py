"""The brain crop a request (cli/predict_single.py:
data/image.determine_brain_crop and the crop's copy): stage_times
brain_crop, from the program's span serve.brain_crop; mean over the
untraced requests. Nothing where the program has no such stage."""

from benchmark.records import stage_mean


def read(record, cell):
    return stage_mean(record, "brain_crop")
