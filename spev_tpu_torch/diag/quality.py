"""Objective quality numbers for validation, numpy only (own copy of the
two JAX-free functions of ``spev_tpu.diag.quality``): mel-cepstral
distortion and per-phoneme duration error, against the reference's
documented targets (MCD < 6 dB, duration error < 10 %)."""

from __future__ import annotations

import numpy as np


def _dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n_out, n_in)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis[0] *= 1.0 / np.sqrt(2.0)
    return (basis * np.sqrt(2.0 / n_in)).astype(np.float32)


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray, n_coeffs: int = 13) -> float:
    """MCD in dB between two log-mel spectrograms (T, n_mels): DCT-II
    cepstra, coefficients 1..n_coeffs (c0 excluded), frames aligned by
    truncation to the shorter length."""
    T = min(mel_a.shape[0], mel_b.shape[0])
    if T == 0:
        return float("nan")
    a, b = np.asarray(mel_a[:T], np.float64), np.asarray(mel_b[:T], np.float64)
    D = _dct_matrix(a.shape[1], n_coeffs + 1)
    diff = (a @ D.T)[:, 1:] - (b @ D.T)[:, 1:]
    const = 10.0 / np.log(10.0) * np.sqrt(2.0)
    return float(const * np.mean(np.sqrt(np.sum(diff**2, axis=1))))


def duration_error_pct(pred_durs: np.ndarray, target_durs: np.ndarray) -> float:
    """Mean relative per-phoneme duration error in percent (valid targets
    only)."""
    p = np.asarray(pred_durs, np.float64)
    t = np.asarray(target_durs, np.float64)
    n = min(len(p), len(t))
    p, t = p[:n], t[:n]
    valid = t > 0
    if not valid.any():
        return float("nan")
    return float(100.0 * np.mean(np.abs(p[valid] - t[valid]) / t[valid]))
