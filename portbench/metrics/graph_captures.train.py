"""CUDA graph captures of the train step (utils/graphs.SignatureGraphs) made inside the window."""

from portbench import readers


def read(record):
    return readers.captures(record, "train")
