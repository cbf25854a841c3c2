"""The grouped expert GEMM's share of its roofline in the Moonlight training window, in percent: operations and bytes from the per-expert routed-row counter (counts_llm.moe_window) over the kernel's time in the device trace."""

from portbench import readers_llm


def read(record):
    return readers_llm.roofline(record, "moe", readers_llm.MOE_GEMM)
