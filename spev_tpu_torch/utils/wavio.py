"""WAV output through the stdlib ``wave`` module (own copy of
``spev_tpu.utils.wavio.write_wav``)."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, data: np.ndarray, sr: int = 22050) -> None:
    """Write a mono float waveform in [-1, 1] as 16-bit PCM."""
    pcm = (np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())

