"""The whole train step: three times the useful operations of FastSpeech 2's
forward over the valid phonemes and frames of the distinct rows of applied
steps (`counts.flops.train_step`), over the traced window, as a share of the
TF32 peak (495 TFLOP/s; the mixed mode runs its backward in TF32)."""

from ttsbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
