"""Inference-time mel-domain voice-quality DSP, on tensors.  Counterpart of
``spev_tpu.ops.mel_dsp``.

- **breathiness**: Gaussian noise injected into mel bins 40-80;
- **roughness**: sinusoidal amplitude modulation of the low mel bins;
- **nasality**: mid-frequency boost + high-frequency attenuation.

They act on log-mel (B, T, n_mels) and compose with the acoustic model's
learned breath/rough/bright controls.  Each is a no-op at strength 0.

The breathiness noise comes from `dsp_noise`, a draw from a CPU
``torch.Generator`` seeded with the caller's seed, moved to the device: the
JAX package's counter-based draw does not depend on the device, and neither
does this one, so the card and the CPU give the same mel.
"""

from __future__ import annotations

import math

import torch


def dsp_noise(shape, seed: int, device) -> torch.Tensor:
    """Standard-normal float32 noise of ``shape``, from
    ``torch.Generator().manual_seed(seed)`` on the CPU, on ``device``."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g).to(device)


def _band(n_mels: int, lo: int, hi: int, like: torch.Tensor) -> torch.Tensor:
    bins = torch.arange(n_mels, device=like.device)
    return ((bins >= lo) & (bins < hi)).to(like.dtype)


def add_breathiness_noise(mel: torch.Tensor, strength, noise: torch.Tensor, lo: int = 40,
                          hi: int = 80) -> torch.Tensor:
    """Add ``strength · 0.5 · noise`` in the high mel bins [lo, hi)."""
    n_mels = mel.shape[-1]
    return mel + strength * 0.5 * noise * _band(n_mels, lo, min(hi, n_mels), mel)


def add_roughness_modulation(mel: torch.Tensor, strength, mod_freq_frames: float = 0.15,
                             lo_bins: int = 20) -> torch.Tensor:
    """Sinusoidal amplitude modulation of the low mel bins (vocal fry /
    growl proxy); mod_freq_frames ≈ cycles per frame (~13 Hz at hop 256)."""
    T, n_mels = mel.shape[-2], mel.shape[-1]
    t = torch.arange(T, dtype=mel.dtype, device=mel.device)
    mod = torch.sin(2.0 * math.pi * mod_freq_frames * t)[:, None]
    return mel + strength * 0.8 * mod * _band(n_mels, 0, lo_bins, mel)


def apply_nasality(mel: torch.Tensor, strength, mid_lo: int = 20, mid_hi: int = 45,
                   high_lo: int = 60) -> torch.Tensor:
    """Mid-frequency boost + high-frequency attenuation (nasal resonance)."""
    n_mels = mel.shape[-1]
    mid = _band(n_mels, mid_lo, mid_hi, mel)
    high = _band(n_mels, high_lo, n_mels, mel)
    return mel + strength * (0.6 * mid - 0.8 * high)


def apply_voice_quality(mel: torch.Tensor, seed: int, breathiness=0.0, roughness=0.0,
                        nasality=0.0, clip_min: float = -10.0,
                        clip_max: float = 2.0) -> torch.Tensor:
    """Compose the three effects (the noise from `dsp_noise` with ``seed``)
    and re-clip to the mel range."""
    mel = add_breathiness_noise(mel, breathiness, dsp_noise(mel.shape, seed, mel.device))
    mel = add_roughness_modulation(mel, roughness)
    mel = apply_nasality(mel, nasality)
    return mel.clamp(clip_min, clip_max)
