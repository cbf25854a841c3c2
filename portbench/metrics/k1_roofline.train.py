"""K1's share of its roofline in the training window, in percent."""

from portbench import readers


def read(record):
    return readers.k1_roofline(record, "train")
