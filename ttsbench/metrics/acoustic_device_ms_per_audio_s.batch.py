"""Acoustic model: device milliseconds of the operations launched inside
`Synthesizer._acoustic` (FastSpeech 2, K1, the mel clean-up) per second of
audio returned."""

from ttsbench.lib.readers import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "Synthesizer._acoustic", "audio_s")
