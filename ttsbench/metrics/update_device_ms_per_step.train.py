"""Clip and AdamW: device milliseconds of the operations launched inside
`Trainer.apply_gradients`, per applied step."""

from ttsbench.lib.readers import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "Trainer.apply_gradients", "steps")
