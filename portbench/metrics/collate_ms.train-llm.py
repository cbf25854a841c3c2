"""Mean host time of the collator (data/collate.py::Collator) per training batch of the Moonlight cell, on the prefetch thread, in the window."""

from portbench import readers, readers_llm


def read(record):
    return readers.mean_ms(record, readers_llm.KIND, "collate")
