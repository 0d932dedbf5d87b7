"""Vocoder: device milliseconds of the operations launched inside
`Vocoder.run` (the HiFi-GAN generator) per second of audio returned."""

from ttsbench.lib.readers import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "Vocoder.run", "audio_s")
