"""Share of the traced training window in which no operation ran on the device, in percent."""

from portbench import readers


def read(record):
    return readers.idle_pct(record, "train")
