"""Frame-level acoustic features: RMS, spectral centroid, YIN/pyin F0 —
counterpart of ``spev_tpu.ops.features``.

The training targets of the dataset build come from here:

- ``rms_energy``: per-frame RMS (zero padding when centred, as librosa's
  ``feature.rms``);
- ``spectral_centroid``: magnitude-weighted mean frequency of an n_fft 2048
  power spectrogram (two fp32 products; the caller sets the precision);
- ``pyin_f0``: the full pyin HMM with librosa's semantics — CMNDF troughs,
  Beta(2, 18) threshold prior split by a Boltzmann rank prior, a
  0.1-semitone pitch lattice doubled into voiced/unvoiced halves, and a
  Viterbi decode over the doubled state space;
- ``yin_f0``: the fast best-trough path with a two-state voicing Viterbi.

The same steps as the JAX package, in PyTorch on the signal's device, with
these differences of form:

- the threshold scan accumulates in threshold order in a Python loop (the
  JAX package's ``lax.scan``);
- the candidate mass goes into pitch bins with ``scatter_add_``.  On the
  card that uses atomics, so where two nonzero candidates of one frame share
  a bin their sum may round differently from run to run; a frame's
  troughs rarely share a 0.1-semitone bin, and a sum with zeros is exact;
- the Viterbi's forward pass is a loop of (2n × 2n) max-plus steps on the
  device (``torch.max`` returns the first maximal index, as ``jnp.argmax``
  does, so ties resolve alike); the backtrace runs on the host;
- ``+ np.finfo(np.float64).tiny`` before the log is a no-op in float32 in
  the JAX package, so ``log_obs`` is ``-inf`` where the observation is 0;
  the port takes the log as it is and keeps those ``-inf``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from spev_tpu_torch.diag.profiling import span
from spev_tpu_torch.ops.stft import device_constant, stft_power

_NO_TROUGH_PROB = 0.01  # librosa pyin default
_SWITCH_PROB = 0.01  # librosa pyin default voiced<->unvoiced transition


def rms_energy(y: torch.Tensor, frame_length: int = 2048, hop_length: int = 256,
               center: bool = True) -> torch.Tensor:
    """Per-frame RMS (``librosa.feature.rms``; zero padding when centred)."""
    if center:
        y = F.pad(y, (frame_length // 2, frame_length // 2))
    frames = y.unfold(0, frame_length, hop_length)
    return torch.sqrt(torch.mean(frames * frames, dim=-1))


def _bin_freqs(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1).astype(np.float32)


def spectral_centroid(y: torch.Tensor, sr: int = 22050, n_fft: int = 2048,
                      hop_length: int = 256) -> torch.Tensor:
    """Spectral centroid in Hz per frame: sum(f·|S|) / sum(|S|)."""
    mag = torch.sqrt(torch.clamp_min(stft_power(y, n_fft=n_fft, hop_length=hop_length), 0.0))
    freqs = device_constant(_bin_freqs, sr, n_fft, device=y.device)
    num = torch.sum(mag * freqs[None, :], dim=-1)
    den = torch.clamp_min(torch.sum(mag, dim=-1), 1e-10)
    return num / den


# ---------------------------------------------------------------------------
# YIN / pyin-lite F0
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _beta_threshold_weights(n_thresholds: int = 100, a: float = 2.0, b: float = 18.0):
    """pyin's Beta(a, b) prior mass over absolute thresholds in (0, 1]."""
    from scipy.stats import beta as beta_dist

    edges = np.linspace(0.0, 1.0, n_thresholds + 1)
    weights = np.diff(beta_dist.cdf(edges, a, b))
    return edges[1:].astype(np.float32), weights.astype(np.float32)


def _cmndf(frames: torch.Tensor, tau_max: int, win_length: int) -> torch.Tensor:
    """Cumulative-mean-normalised difference function, (N, tau_max + 1),
    with d'(0) = 1; the cross-correlation through an FFT."""
    n_frames, frame_length = frames.shape
    w = win_length
    n_pad = int(2 ** np.ceil(np.log2(frame_length + tau_max + 1)))
    fx = torch.fft.rfft(frames, n=n_pad, dim=-1)
    fw = torch.fft.rfft(frames[:, :w], n=n_pad, dim=-1)
    corr = torch.fft.irfft(fx * torch.conj(fw), n=n_pad, dim=-1)[:, : tau_max + 1]
    # e(tau) = sum_{j<w} x[j+tau]^2 from a running sum of squares
    csum = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    tau = torch.arange(tau_max + 1, device=frames.device)
    e_tau = csum[:, tau + w] - csum[:, tau]
    diff = torch.clamp_min(e_tau[:, :1] + e_tau - 2.0 * corr, 0.0)
    cum = torch.cumsum(diff[:, 1:], dim=-1)
    lags = torch.arange(1, tau_max + 1, device=frames.device, dtype=frames.dtype)
    cmndf = diff[:, 1:] * lags / torch.clamp_min(cum, 1e-12)
    return F.pad(cmndf, (1, 0), value=1.0)


def _f0_frames(y: torch.Tensor, sr: int, fmin: float, fmax: float, frame_length: int,
               hop_length: int, center: bool):
    """(CMNDF (N, tau_max + 1), tau_min, tau_max) of the zero-padded frames."""
    win_length = frame_length // 2
    tau_min = max(1, int(sr / fmax))
    tau_max = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    if center:
        y = F.pad(y, (frame_length // 2, frame_length // 2))
    frames = y.unfold(0, frame_length, hop_length)
    return _cmndf(frames, tau_max, win_length), tau_min, tau_max


def yin_f0(y: torch.Tensor, sr: int = 22050, fmin: float = 60.0, fmax: float = 500.0,
           frame_length: int = 2048, hop_length: int = 512, center: bool = True,
           viterbi: bool = True):
    """pyin-lite: (f0, voiced_flag, voiced_prob), each (n_frames,).  The same
    Beta-prior voicing mass as `pyin_f0`, per-frame best-trough F0 with
    parabolic interpolation, and a two-state voicing Viterbi (switch 0.01);
    f0 is NaN where unvoiced."""
    cmndf, tau_min, tau_max = _f0_frames(y, sr, fmin, fmax, frame_length, hop_length, center)
    dev = cmndf.device
    lags = torch.arange(tau_max + 1, device=dev)
    in_range = (lags >= tau_min) & (lags <= tau_max)
    masked = torch.where(in_range[None, :], cmndf, torch.inf)
    interior = masked[:, 1:-1]
    is_trough = (interior < masked[:, :-2]) & (interior <= masked[:, 2:])
    trough_vals = torch.where(is_trough, interior, torch.inf)

    thresholds, weights = _beta_threshold_weights()
    min_trough = torch.min(trough_vals, dim=-1).values
    below = min_trough[:, None] < torch.as_tensor(thresholds, device=dev)[None, :]
    p_any = torch.sum(torch.as_tensor(weights, device=dev)[None, :] * below, dim=-1)
    voiced_prob = torch.clamp(p_any + _NO_TROUGH_PROB * (1.0 - p_any), 0.0, 1.0)

    # F0 candidate: the first trough under 0.1, else the global minimum
    under = trough_vals < 0.1
    first_under = torch.argmax(under.to(torch.int32), dim=-1)
    global_min = torch.argmin(trough_vals, dim=-1)
    best = torch.where(under.any(dim=-1), first_under, global_min) + 1
    rows = torch.arange(cmndf.shape[0], device=dev)
    c0 = cmndf[rows, torch.clamp_min(best - 1, 0)]
    c1 = cmndf[rows, best]
    c2 = cmndf[rows, torch.clamp_max(best + 1, tau_max)]
    denom = c0 + c2 - 2.0 * c1
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (c0 - c2) / denom,
                        torch.zeros_like(denom))
    period = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    f0 = torch.clamp(sr / torch.clamp_min(period, 1e-6), fmin, fmax)
    if viterbi:
        voiced_flag = torch.as_tensor(_viterbi_voicing(voiced_prob.cpu().numpy()), device=dev)
    else:
        voiced_flag = voiced_prob > 0.5
    f0 = torch.where(voiced_flag, f0, torch.nan)
    return f0, voiced_flag, voiced_prob


def _viterbi_voicing(voiced_prob: np.ndarray) -> np.ndarray:
    """Two-state (unvoiced 0 / voiced 1) Viterbi over per-frame voicing
    probabilities, float32 on the host; uniform start, switch 0.01."""
    eps = np.float32(1e-10)
    vp = np.asarray(voiced_prob, np.float32)
    obs = np.stack([np.log(np.float32(1.0) - vp + eps), np.log(vp + eps)], axis=-1)
    log_stay = np.float32(np.log(1.0 - _SWITCH_PROB))
    log_switch = np.float32(np.log(_SWITCH_PROB))
    n = len(vp)
    carry = np.log(np.asarray([0.5, 0.5], np.float32)) + obs[0]
    ptrs = np.zeros((max(n - 1, 0), 2), np.int32)
    for t in range(1, n):
        stay = carry + log_stay
        switch = carry[::-1] + log_switch
        ptrs[t - 1] = switch > stay  # 1: came from the other state
        carry = np.maximum(stay, switch) + obs[t]
    states = np.zeros(n, np.int32)
    states[-1] = int(np.argmax(carry))
    for t in range(n - 2, -1, -1):
        s = states[t + 1]
        states[t] = 1 - s if ptrs[t, s] == 1 else s
    return states.astype(bool)


# ---------------------------------------------------------------------------
# Full pyin: candidate-lattice HMM (librosa semantics)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pyin_lattice(sr: int, fmin: float, fmax: float, hop_length: int,
                  n_bins_per_semitone: int, max_transition_rate: float, switch_prob: float):
    """(n_bins, bin frequencies, log-transition (2n, 2n), log-initial (2n,)),
    numpy float32, once per config: ``n_bins = floor(12·bps·log2(fmax/fmin))
    + 1`` bins at 1/bps semitone; a triangular local window of half-width
    ``round(rate·12·hop/sr)·bps`` bins, truncated at the edges and
    renormalised per row; voicing flips with ``switch_prob``; the chain
    starts uniform over the unvoiced half."""
    bps = n_bins_per_semitone
    n_bins = int(np.floor(12 * bps * np.log2(fmax / fmin))) + 1
    freqs = fmin * 2.0 ** (np.arange(n_bins) / (12.0 * bps))

    max_semitones_per_frame = round(max_transition_rate * 12 * hop_length / sr)
    width = max_semitones_per_frame * bps + 1
    half = width // 2
    offs = np.arange(-half, half + 1)
    tri = (half + 1 - np.abs(offs)) / (half + 1)
    local = np.zeros((n_bins, n_bins))
    for i in range(n_bins):
        lo, hi = max(0, i - half), min(n_bins, i + half + 1)
        local[i, lo:hi] = tri[(lo - i) + half : (hi - i) + half]
    local /= local.sum(axis=1, keepdims=True)

    t_switch = np.array([[1.0 - switch_prob, switch_prob], [switch_prob, 1.0 - switch_prob]])
    transition = np.kron(t_switch, local)
    p_init = np.zeros(2 * n_bins)
    p_init[n_bins:] = 1.0 / n_bins

    tiny = np.finfo(np.float64).tiny
    log_trans = np.log(transition + tiny).astype(np.float32)
    log_init = np.log(p_init + tiny).astype(np.float32)
    return n_bins, freqs.astype(np.float32), log_trans, log_init


def _pyin_log_trans(*lattice) -> np.ndarray:
    return _pyin_lattice(*lattice)[2]


def _pyin_log_init(*lattice) -> np.ndarray:
    return _pyin_lattice(*lattice)[3]


def _trough_probs(band: torch.Tensor, n_thresholds: int, beta_a: float, beta_b: float,
                  boltzmann_parameter: float, no_trough_prob: float):
    """Per-lag candidate probabilities and parabolic shifts, both (N, L),
    for the CMNDF band [tau_min, tau_max].  A lag is a trough when it is a
    local minimum (strict left, non-strict right, edge-padded; the first lag
    iff band[0] < band[1]).  Each threshold's Beta mass is split over the
    troughs under it by a Boltzmann prior on their rank in lag order; a
    threshold no trough clears gives ``no_trough_prob`` of its mass to the
    lowest trough."""
    n, L = band.shape
    thresholds, beta_w = _beta_threshold_weights(n_thresholds, beta_a, beta_b)
    left = torch.cat([band[:, :1], band[:, :-1]], dim=1)
    right = torch.cat([band[:, 1:], band[:, -1:]], dim=1)
    is_trough = (band < left) & (band <= right)
    is_trough[:, 0] = band[:, 0] < band[:, 1]
    heights = torch.where(is_trough, band, torch.inf)
    global_min = torch.argmin(heights, dim=1)

    lam = boltzmann_parameter
    one_minus = 1.0 - float(np.exp(-lam))
    probs = torch.zeros((n, L), device=band.device)
    nt_mass = torch.zeros((n,), device=band.device)
    for thr, w in zip(thresholds.tolist(), beta_w.tolist()):  # threshold order
        qual = heights < thr
        n_troughs = torch.sum(qual, dim=1, keepdim=True)
        rank = torch.cumsum(qual, dim=1) - 1
        denom = 1.0 - torch.exp(-lam * torch.clamp_min(n_troughs, 1).to(torch.float32))
        boltz = one_minus * torch.exp(-lam * rank.to(torch.float32)) / denom
        probs += w * torch.where(qual, boltz, 0.0)
        nt_mass += w * (n_troughs[:, 0] == 0)
    rows = torch.arange(n, device=band.device)
    probs[rows, global_min] += no_trough_prob * nt_mass
    # mass only on real troughs (an all-unvoiced frame's argmin may not be one)
    any_trough = torch.any(is_trough, dim=1, keepdim=True)
    probs = torch.where(is_trough & any_trough, probs, 0.0)

    # parabolic shifts; boundary lags keep 0, |shift| > 1 is zeroed
    c0, c1, c2 = band[:, :-2], band[:, 1:-1], band[:, 2:]
    a = (c0 + c2 - 2.0 * c1) / 2.0
    b = (c2 - c0) / 2.0
    shift_mid = -b / (2.0 * a + 1e-30)
    shift_mid = torch.where(torch.abs(shift_mid) > 1.0, 0.0, shift_mid)
    return probs, F.pad(shift_mid, (1, 1))


def _viterbi(log_obs: torch.Tensor, log_trans: torch.Tensor, log_init: torch.Tensor) -> np.ndarray:
    """Most likely state path (N,) of a dense HMM in log space: the forward
    max-plus steps on the device, the backtrace on the host."""
    n, S = log_obs.shape
    ptrs = torch.empty((max(n - 1, 0), S), dtype=torch.int64, device=log_obs.device)
    carry = log_init + log_obs[0]
    for t in range(1, n):
        best, ptr = torch.max(carry[:, None] + log_trans, dim=0)  # first maximal prev state
        ptrs[t - 1] = ptr
        carry = best + log_obs[t]
    ptrs = ptrs.cpu().numpy()
    states = np.zeros(n, np.int64)
    states[-1] = int(torch.argmax(carry))
    for t in range(n - 2, -1, -1):
        states[t] = ptrs[t, states[t + 1]]
    return states


def pyin_f0(y: torch.Tensor, sr: int = 22050, fmin: float = 60.0, fmax: float = 500.0,
            frame_length: int = 2048, hop_length: int = 512, center: bool = True,
            n_thresholds: int = 100, beta_parameters: tuple = (2.0, 18.0),
            boltzmann_parameter: float = 2.0, resolution: float = 0.1,
            max_transition_rate: float = 35.92, switch_prob: float = 0.01,
            no_trough_prob: float = 0.01):
    """Full pyin: (f0, voiced_flag, voiced_prob), each (n_frames,).
    ``voiced_prob`` is the per-frame voiced candidate mass before the
    Viterbi (clipped to [0, 1]); ``f0`` the decoded bin's centre frequency,
    NaN where the decoded state is unvoiced."""
    bps = int(np.ceil(1.0 / resolution))
    n_bins, freqs, _, _ = _pyin_lattice(sr, fmin, fmax, hop_length, bps, max_transition_rate,
                                        switch_prob)
    with span("spev.pyin.cmndf"):
        cmndf, tau_min, tau_max = _f0_frames(y, sr, fmin, fmax, frame_length, hop_length,
                                             center)
    dev = cmndf.device
    band = cmndf[:, tau_min : tau_max + 1]
    n = band.shape[0]
    with span("spev.pyin.trough_probs"):
        probs, shifts = _trough_probs(band, n_thresholds, *beta_parameters,
                                      boltzmann_parameter, no_trough_prob)

    periods = torch.arange(tau_min, tau_max + 1, dtype=torch.float32, device=dev)[None, :] + shifts
    f0_cand = sr / torch.clamp_min(periods, 1e-6)
    bin_idx = 12.0 * bps * torch.log2(torch.clamp_min(f0_cand, 1e-6) / fmin)
    bin_idx = torch.clamp(torch.round(bin_idx), 0, n_bins).to(torch.int64)
    # candidate mass into the voiced half; bin n_bins is dropped
    obs_voiced = torch.zeros((n, n_bins + 1), device=dev).scatter_add_(1, bin_idx, probs)[:, :n_bins]
    voiced_prob = torch.clamp(torch.sum(obs_voiced, dim=1), 0.0, 1.0)
    obs_unvoiced = ((1.0 - voiced_prob) / n_bins)[:, None].expand(n, n_bins)
    log_obs = torch.log(torch.cat([obs_voiced, obs_unvoiced], dim=1))

    lattice = (sr, fmin, fmax, hop_length, bps, max_transition_rate, switch_prob)
    with span("spev.pyin.viterbi"):
        states = _viterbi(log_obs, device_constant(_pyin_log_trans, *lattice, device=dev),
                          device_constant(_pyin_log_init, *lattice, device=dev))
    voiced = states < n_bins
    f0 = np.where(voiced, freqs[states % n_bins], np.float32(np.nan)).astype(np.float32)
    return (torch.as_tensor(f0, device=dev), torch.as_tensor(voiced, device=dev), voiced_prob)
