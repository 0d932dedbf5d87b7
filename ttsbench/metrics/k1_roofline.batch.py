"""Kernel K1 (`csrc/length_regulator.cu`, `lr_fused_kernel`): its least time
(bytes read once and written once at 3.35 TB/s, `counts.bytes.k1`) over its
device time, summed over the traced calls."""

from ttsbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "k1_bytes", "k1_s")
