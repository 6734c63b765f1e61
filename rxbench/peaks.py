"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline and
utilization the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12   # device memory rate
BF16_FLOPS = 989e12         # bf16 tensor cores, dense
F32_FLOPS = 67e12           # float32 outside the tensor cores
