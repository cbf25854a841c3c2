"""Share of the Moonlight cell's traced training window in which no operation ran on the device, in percent."""

from portbench import readers, readers_llm


def read(record):
    return readers.idle_pct(record, readers_llm.KIND)
