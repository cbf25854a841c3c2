"""The Moonlight training step's share of the published peaks: least time for the window's model FLOPs (the encoder's active FLOPs at bf16 989 TFLOP/s, the fusion stack's and the router's at fp32 67) over the traced window, in percent."""

from portbench import readers, readers_llm


def read(record):
    return readers.step_mfu(record, readers_llm.KIND)
