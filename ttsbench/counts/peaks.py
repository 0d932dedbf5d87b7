"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit); the same table as ``diag/disc_roofline.py``."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp16": 989e12, "fp8": 1979e12}
