"""The scoring step's share of the published peaks: least time for the window's model FLOPs over the traced window, in percent."""

from portbench import readers


def read(record):
    return readers.step_mfu(record, "offline")
