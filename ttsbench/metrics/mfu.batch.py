"""The whole synthesis step: useful operations of FastSpeech 2 and the
generator over the valid phonemes, frames and samples returned
(`counts.flops`), over the traced window, as a share of the TF32 peak
(495 TFLOP/s)."""

from ttsbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
