"""CUDA graph captures of the eval step (utils/graphs.SignatureGraphs) made inside the window."""

from portbench import readers


def read(record):
    return readers.captures(record, "offline")
