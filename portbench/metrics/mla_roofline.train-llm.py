"""The latent attention's kernel (bf16, 192-wide query/key and 128-wide value heads) at its roofline in the Moonlight training window, in percent."""

from portbench import readers_llm


def read(record):
    return readers_llm.roofline(record, "mla", readers_llm.MLA)
