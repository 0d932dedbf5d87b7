"""Kernel K1b (`lr_fused_bwd_kernel`): its least time (`counts.bytes.k1b`:
the valid frames gradients read once, the phoneme gradients written once, at
3.35 TB/s) over its device time, summed over the traced calls."""

from ttsbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "k1b_bytes", "k1b_s")
