"""Framed STFT and inverse STFT as matmuls — counterpart of
``spev_tpu.ops.stft``.

The constants (periodic Hann window, rDFT bases, slaney mel
filterbank) are numpy, copied from the reference so both packages use the
same numbers.  The DFT is two float32 matmuls against cos/sin bases;
`istft`'s overlap-add is kernel K3 (`ops.cuda.kernels.overlap_add`), which on
CPU tensors is its plain version.  The numpy constants are moved to each
device once and kept (`device_constant`).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spev_tpu_torch.ops.cuda.kernels import overlap_add


# ---------------------------------------------------------------------------
# host-side constants (numpy)
# ---------------------------------------------------------------------------


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (``scipy.signal.get_window('hann', N)``)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rDFT bases of shape (n_fft, n_fft//2+1)."""
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa ``hz_to_mel(htk=False)``)."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    return np.where(
        log_t,
        min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int = 22050, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_freqs)
    (``librosa.filters.mel`` with htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def _inverse_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """irfft as matmuls: x[n] = (1/N) Σ_k scale_k (re_k cos - im_k sin);
    the sin basis is the forward basis (-sin), so im enters with +."""
    cos_b, sin_b = _dft_bases(n_fft)
    scale = np.full((n_fft // 2 + 1,), 2.0, dtype=np.float32)
    scale[0] = scale[-1] = 1.0
    cos_t = (cos_b * scale[None, :]).astype(np.float32) / n_fft
    sin_t = (sin_b * scale[None, :]).astype(np.float32) / n_fft
    return np.ascontiguousarray(cos_t.T), np.ascontiguousarray(sin_t.T)


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def device_constant(build: Callable[..., np.ndarray], *args, device) -> torch.Tensor:
    """``build(*args)`` (a numpy constant) as a float32 tensor on ``device``,
    made once per (function, args, device)."""
    key = (build.__qualname__, args, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(build(*args), dtype=torch.float32,
                                              device=device).contiguous()
    return t


def _dft_cos(n_fft: int) -> np.ndarray:
    return _dft_bases(n_fft)[0]


def _dft_sin(n_fft: int) -> np.ndarray:
    return _dft_bases(n_fft)[1]


def _idft_cos(n_fft: int) -> np.ndarray:
    return _inverse_bases(n_fft)[0]


def _idft_sin(n_fft: int) -> np.ndarray:
    return _inverse_bases(n_fft)[1]


# ---------------------------------------------------------------------------
# device-side ops
# ---------------------------------------------------------------------------


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int, center: bool = True) -> torch.Tensor:
    """(n_frames, n_fft) overlapping frames of a 1-D signal; ``center``
    reflect-pads by n_fft//2, so n_frames = 1 + len(y) // hop."""
    if center:
        y = F.pad(y[None], (n_fft // 2, n_fft // 2), mode="reflect")[0]
    return y.unfold(0, n_fft, hop_length)


def stft_complex(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int | None = None, center: bool = True):
    """(real, imag) STFT parts, each (n_frames, n_freqs)."""
    win = device_constant(hann_window, win_length or n_fft, device=y.device)
    frames = frame_signal(y, n_fft, hop_length, center) * win[None, :]
    re = frames @ device_constant(_dft_cos, n_fft, device=y.device)
    im = frames @ device_constant(_dft_sin, n_fft, device=y.device)
    return re, im


def stft_power(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
               center: bool = True) -> torch.Tensor:
    """Power spectrogram |STFT|², (n_frames, n_freqs): two float32 products
    against the rDFT bases (the caller sets the matmul precision).  The
    log-mel is kernel K2 (`ops.cuda.kernels.fused_log_mel`)."""
    re, im = stft_complex(y, n_fft, hop_length, center=center)
    return re * re + im * im


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          length: int | None = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT: inverse rDFT as two matmuls, Hann synthesis window, then
    overlap-add with COLA normalisation (kernel K3)."""
    dev = re.device
    frames = (re @ device_constant(_idft_cos, n_fft, device=dev)
              + im @ device_constant(_idft_sin, n_fft, device=dev))
    win = device_constant(hann_window, n_fft, device=dev)
    sig = overlap_add((frames * win[None, :]).contiguous(), win, hop_length)
    if center:
        sig = sig[n_fft // 2 : sig.shape[0] - n_fft // 2]
    if length is not None:
        if sig.shape[0] < length:  # zero-pad when asked for more, as librosa
            sig = F.pad(sig, (0, length - sig.shape[0]))
        else:
            sig = sig[:length]
    return sig
