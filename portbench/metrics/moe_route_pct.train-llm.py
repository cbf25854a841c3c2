"""The share of the Moonlight training window's device time in the routing, permutation and combine kernels, in percent."""

from portbench import readers_llm


def read(record):
    return readers_llm.route_pct(record)
