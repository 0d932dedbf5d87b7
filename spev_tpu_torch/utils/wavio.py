"""WAV input and output without libsndfile (own copy of
``spev_tpu.utils.wavio``).

`read_wav` parses the RIFF header itself, so it takes 8/16/24/32-bit PCM,
IEEE float and WAVE_FORMAT_EXTENSIBLE files, and averages channels to mono.
The dataset build and the vocoder's crop loader decode with the C++ reader
(`spev_tpu_torch.utils.native`), which hands this reader the files it
refuses.
"""

from __future__ import annotations

import struct
import wave

import numpy as np

from spev_tpu_torch.errors import UserError


def write_wav(path: str, data: np.ndarray, sr: int = 22050) -> None:
    """Write a mono float waveform in [-1, 1] as 16-bit PCM."""
    pcm = (np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A WAV file as (float32 mono waveform in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise UserError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise UserError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    # WAVE_FORMAT_EXTENSIBLE: the sub-format GUID starts at byte 24 of the
    # fmt chunk (the JAX reader reads it from the last chunk, usually data)
    if audio_format == 0xFFFE:
        audio_format = struct.unpack("<H", fmt[24:26])[0] if len(fmt) >= 26 else 1
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        x = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif bits == 8:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise UserError(f"{path}: unsupported bit depth {bits}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def resample_linear(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler for dataset preparation."""
    if sr_in == sr_out:
        return y
    n_out = int(round(len(y) * sr_out / sr_in))
    xi = np.linspace(0.0, len(y) - 1, n_out)
    return np.interp(xi, np.arange(len(y)), y).astype(np.float32)
