"""Mean host time of the collator (data/collate.py::Collator) per training batch, on the prefetch thread, in the window."""

from portbench import readers


def read(record):
    return readers.mean_ms(record, "train", "collate")
