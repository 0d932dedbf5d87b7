"""Griffin-Lim vocoder fallback — counterpart of ``spev_tpu.ops.griffin_lim``.

``librosa.feature.inverse.mel_to_audio`` semantics: (1) a projected-gradient
NNLS inversion of the mel filterbank to a linear power spectrogram and
(2) 32 Griffin-Lim iterations with momentum 0.99.  The JAX ``lax.scan``
loops are Python loops here; the matmuls stay float32 ``torch.matmul``, and
every ISTFT's overlap-add is kernel K3 (33 launches per request).

The random initial phase comes from a ``torch.Generator`` seeded with
``seed`` (drawn on the CPU, so it is the same on every device).  It cannot
match JAX's bits, so `griffin_lim` and `mel_to_audio` also take the phase
itself (``init_phase``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from spev_tpu_torch.ops.stft import device_constant, istft, mel_filterbank, stft_complex


def nnls_mel_inverse(mel_power: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                     fmin: float = 0.0, fmax: float = 8000.0, n_iter: int = 60) -> torch.Tensor:
    """Power mel (n_mels, T) → linear power spectrogram (T, n_freqs) by
    projected-gradient NNLS (librosa ``mel_to_stft``)."""
    n_mels = mel_power.shape[0]
    args = (sr, n_fft, n_mels, fmin, fmax)
    A = device_constant(mel_filterbank, *args, device=mel_power.device)  # (M, F)
    # step 1/L, L the largest eigenvalue of AᵀA (constant filterbank)
    step = 1.0 / max(float(np.linalg.norm(mel_filterbank(*args), 2) ** 2), 1e-8)
    At = A.T
    x = torch.clamp_min(At @ mel_power, 0.0)  # (F, T)
    for _ in range(n_iter):
        x = torch.clamp_min(x - step * (At @ (A @ x - mel_power)), 0.0)
    return x.T


def random_phase(T: int, F: int, seed: int = 0) -> torch.Tensor:
    """U(-π, π) phases (T, F) from ``torch.Generator().manual_seed(seed)``."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((T, F), generator=g) * (2 * math.pi) - math.pi


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                n_iter: int = 32, momentum: float = 0.99, length: Optional[int] = None,
                seed: int = 0, init_phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Magnitude (T, n_freqs) → waveform, with librosa's momentum update.
    init_phase: (T, n_freqs) initial phases; default `random_phase(seed)`."""
    T, F = magnitude.shape
    # fewer frames than one window of overlap cannot be projected through
    # ISTFT→STFT (reflect padding would exceed the signal): silence
    if T * hop_length < n_fft:
        n = length if length is not None else hop_length * max(T - 1, 0)
        return magnitude.new_zeros((n,))
    phase = random_phase(T, F, seed) if init_phase is None else torch.as_tensor(init_phase)
    phase = phase.to(device=magnitude.device, dtype=magnitude.dtype)
    ang_re, ang_im = torch.cos(phase), torch.sin(phase)
    # iterate at the length whose re-STFT has exactly T frames; the
    # requested length applies to the final pass only
    iter_len = hop_length * (T - 1)
    prev_re = torch.zeros_like(ang_re)
    prev_im = torch.zeros_like(ang_im)
    c = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        sig = istft(magnitude * ang_re, magnitude * ang_im, n_fft, hop_length, length=iter_len)
        reb_re, reb_im = stft_complex(sig, n_fft, hop_length)
        new_re = reb_re - c * prev_re
        new_im = reb_im - c * prev_im
        mag = torch.sqrt(new_re * new_re + new_im * new_im) + 1e-16
        ang_re, ang_im, prev_re, prev_im = new_re / mag, new_im / mag, reb_re, reb_im
    final_len = length if length is not None else iter_len
    return istft(magnitude * ang_re, magnitude * ang_im, n_fft, hop_length, length=final_len)


def mel_to_audio(mel_power: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                 hop_length: int = 256, fmin: float = 0.0, fmax: float = 8000.0,
                 n_iter: int = 32, seed: int = 0,
                 init_phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Power mel (n_mels, T) → waveform of hop·T samples."""
    power = nnls_mel_inverse(mel_power, sr, n_fft, fmin, fmax)
    magnitude = torch.sqrt(torch.clamp_min(power, 0.0))
    return griffin_lim(magnitude, n_fft=n_fft, hop_length=hop_length, n_iter=n_iter,
                       seed=seed, length=hop_length * mel_power.shape[1],
                       init_phase=init_phase)
