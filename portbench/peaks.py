"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {
    "float32": 67e12,     # fp32 outside the tensor cores (TF32 is off)
    "bfloat16": 989e12,   # bf16 on the tensor cores
}
