"""Mean host time of the collator (data/collate.py::Collator) per scored batch, on the prefetch thread, in the window."""

from portbench import readers


def read(record):
    return readers.mean_ms(record, "offline", "collate")
