"""CUDA graph captures of the Moonlight train step (utils/graphs.SignatureGraphs) made inside the window."""

from portbench import readers, readers_llm


def read(record):
    return readers.captures(record, readers_llm.KIND)
