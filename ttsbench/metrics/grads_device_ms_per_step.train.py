"""Forward, loss and backward: device milliseconds of the operations
launched inside `Trainer.global_gradients`, per applied step."""

from ttsbench.lib.readers import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "Trainer.global_gradients", "steps")
