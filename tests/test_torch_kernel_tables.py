"""The host-side pieces that K2's FFT body (spev_tpu_torch/csrc/log_mel.cu)
depends on, on the CPU: the mel bands' [lo, hi) ranges and their taps by
parity, the float64-made twiddle table, the reflect index map, and the
Stockham schedule the kernel runs over that table, each mirrored in numpy
from a seed at n_fft 512 and 1024, fmax 8000 and sr/2."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spev_tpu_torch.ops import stft

SR = 22050
GRID = [(n_fft, fmax) for n_fft in (512, 1024) for fmax in (8000.0, SR / 2)]
IDS = [f"nfft{n}_fmax{int(f)}" for n, f in GRID]


def _fmaf(a, b, c):
    """float32 fmaf emulated in float64: the product of two float32 values is
    exact there; the sum is rounded to float64, then to float32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _powers(n_frames, n_freqs, seed):
    """Power spectra over a wide range (1e-12 to 1e4), with exact zeros."""
    rng = np.random.default_rng(seed)
    p = np.exp(rng.uniform(np.log(1e-12), np.log(1e4), (n_frames, n_freqs))).astype(np.float32)
    p[rng.random(p.shape) < 0.05] = 0.0
    return p


@pytest.mark.parametrize("n_fft,fmax", GRID, ids=IDS)
def test_mel_band_ranges_cover_every_nonzero(n_fft, fmax):
    fb = stft.mel_filterbank(SR, n_fft, 80, 0.0, fmax)
    bands = stft.mel_band_ranges(SR, n_fft, 80, 0.0, fmax)
    assert bands.dtype == np.int32 and bands.shape == (80, 2)
    bins = np.arange(fb.shape[1])
    inside = (bins[None, :] >= bands[:, :1]) & (bins[None, :] < bands[:, 1:])
    assert not (fb[~inside] != 0).any()
    # tight: each range starts and ends on a nonzero tap
    for m, (lo, hi) in enumerate(bands):
        assert hi > lo and fb[m, lo] != 0 and fb[m, hi - 1] != 0


@pytest.mark.parametrize("n_fft,fmax", GRID, ids=IDS)
def test_band_sum_is_bit_equal_to_the_dense_fmaf_order(n_fft, fmax):
    fb = stft.mel_filterbank(SR, n_fft, 80, 0.0, fmax)
    bands = stft.mel_band_ranges(SR, n_fft, 80, 0.0, fmax)
    p = _powers(16, n_fft // 2 + 1, seed=n_fft)
    dense = np.zeros((16, 80), np.float32)
    for k in range(fb.shape[1]):  # every bin, zero taps included, ascending
        dense = _fmaf(p[:, k:k + 1], fb[None, :, k], dense)
    for m, (lo, hi) in enumerate(bands):
        acc = np.zeros(16, np.float32)
        for k in range(lo, hi):
            acc = _fmaf(p[:, k], np.full(16, fb[m, k]), acc)
        assert np.array_equal(acc.view(np.int32), dense[:, m].view(np.int32)), m


@pytest.mark.parametrize("n_fft,fmax", GRID, ids=IDS)
def test_taps_by_parity_hold_every_band_tap(n_fft, fmax):
    fb = stft.mel_filterbank(SR, n_fft, 80, 0.0, fmax)
    taps = stft.mel_taps_by_parity(SR, n_fft, 80, 0.0, fmax)
    assert taps.dtype == np.float32 and taps.shape == (n_fft // 2 + 1, 2)
    for m, (lo, hi) in enumerate(stft.mel_band_ranges(SR, n_fft, 80, 0.0, fmax)):
        assert np.array_equal(taps[lo:hi, m % 2].view(np.int32), fb[m, lo:hi].view(np.int32))


def test_taps_by_parity_refuse_overlapping_bands():
    with np.errstate(all="ignore"), pytest.raises(ValueError, match="share a bin"):
        stft.mel_taps_by_parity(SR, 512, 80, 4000.0, 4000.0)  # fmin = fmax: no triangles


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_fft_twiddles_within_one_ulp(n_fft):
    tw = stft.fft_twiddles(n_fft)
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    assert tw.dtype == np.float32 and tw.shape == (n_fft, 2)
    for got, want in ((tw[:, 0], np.cos(ang)), (tw[:, 1], -np.sin(ang))):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


def _reflect_index(q, pad, length):
    """log_mel.cu:reflect_index, elementwise: the index into y of sample q
    of y reflect-padded by `pad` on each side."""
    s = np.abs(q - pad)
    return np.where(s >= length, 2 * (length - 1) - s, s)


@pytest.mark.parametrize("n,n_fft", [(513, 1024), (1000, 1024), (22050, 1024), (257, 512),
                                     (8192, 512)])
def test_reflect_index_map_equals_pad(n, n_fft):
    y = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    padded = F.pad(y[None], (n_fft // 2, n_fft // 2), mode="reflect")[0]
    q = np.arange(n + n_fft)
    assert torch.equal(y[torch.from_numpy(_reflect_index(q, n_fft // 2, n))], padded)


def _dft(v):
    """log_mel.cu:dft<R>, the same butterflies for R = 2, 4, 8 (v: R arrays
    of complex64)."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        s0, d0, s1, d1 = v[0] + v[2], v[0] - v[2], v[1] + v[3], -1j * (v[1] - v[3])
        return [s0 + s1, d0 + d1, s0 - s1, d0 - d1]
    r = np.float32(np.sqrt(0.5))
    e, o = _dft(v[0::2]), _dft(v[1::2])
    o[1] = ((o[1].real + o[1].imag) * r + 1j * (o[1].imag - o[1].real) * r).astype(np.complex64)
    o[2] = (-1j * o[2]).astype(np.complex64)
    o[3] = ((o[3].imag - o[3].real) * r - 1j * (o[3].real + o[3].imag) * r).astype(np.complex64)
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def _rfft_power(x, n_fft):
    """The kernel's schedule in complex64: x (frames, n_fft) packed as n2 =
    n_fft/2 complex points, Stockham passes of radix 8, then 4 or 2, over
    the twiddle table, then the real-input post-processing and the power."""
    tw = stft.fft_twiddles(n_fft)
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    n2 = n_fft // 2
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    ns = 1
    while ns < n2:
        R = 8 if n2 // ns >= 8 else (4 if n2 // ns >= 4 else 2)
        q, out = n2 // R, np.empty_like(z)
        j = np.arange(q)
        k = j & (ns - 1)
        v = [z[:, j + r * q] * w[r * k * (n_fft // (ns * R))] for r in range(R)]
        for r, vr in enumerate(_dft(v)):
            out[:, (j - k) * R + k + r * ns] = vr
        z, ns = out, ns * R
    k = np.arange(n2 + 1)
    a, c = z[:, k % n2], z[:, (n2 - k) % n2]
    e = (a + np.conj(c)) * np.float32(0.5)
    o = -1j * (a - np.conj(c)) * np.float32(0.5)
    X = e + w[k] * o
    return X.real.astype(np.float32) ** 2 + X.imag.astype(np.float32) ** 2


@pytest.mark.parametrize("n_fft", [4, 16, 64, 512, 1024])
def test_fft_schedule_matches_rfft(n_fft):
    x = np.random.default_rng(n_fft).standard_normal((8, n_fft)).astype(np.float32)
    ref = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
    got = _rfft_power(x, n_fft)
    assert got.shape == ref.shape
    # float32 rounding through log2(n) passes, against the frame's energy
    assert np.abs(got - ref).max() <= 1e-5 * ref.max()


def test_device_constant_keeps_dtypes_apart():
    f = stft.device_constant(stft.mel_band_ranges, SR, 512, 80, 0.0, 8000.0, device="cpu")
    i = stft.device_constant(stft.mel_band_ranges, SR, 512, 80, 0.0, 8000.0, device="cpu",
                             dtype=torch.int32)
    assert f.dtype == torch.float32 and i.dtype == torch.int32 and torch.equal(i.float(), f)
    assert i is stft.device_constant(stft.mel_band_ranges, SR, 512, 80, 0.0, 8000.0,
                                     device="cpu", dtype=torch.int32)
