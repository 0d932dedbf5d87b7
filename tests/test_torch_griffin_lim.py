"""The PyTorch port's STFT, overlap-add and Griffin-Lim against the JAX
package's: the plain overlap-add within 1e-5 of the Pallas kernel (interpret
mode), stft_complex / istft within 1e-4, NNLS within 1e-4 relative, and
Griffin-Lim from the same initial phase (n_iter=4) within 1e-4 — looser than
one ISTFT because the momentum loop amplifies differences in summation
order."""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spev_tpu.ops.pallas.kernels import overlap_add as jax_overlap_add
from spev_tpu_torch.ops import griffin_lim as tgl
from spev_tpu_torch.ops import stft as tstft
from spev_tpu_torch.ops.cuda.kernels import overlap_add, overlap_add_plain

# spev_tpu.ops re-exports functions under these module names
jgl = importlib.import_module("spev_tpu.ops.griffin_lim")
jstft = importlib.import_module("spev_tpu.ops.stft")


def _signal(n, seed=0):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * r.standard_normal(n)).astype(np.float32)


def test_constants_are_the_references():
    np.testing.assert_array_equal(tstft.hann_window(1024), jstft.hann_window(1024))
    np.testing.assert_array_equal(tstft.mel_filterbank(), jstft.mel_filterbank())
    for a, b in zip(tstft._dft_bases(1024), jstft._dft_bases(1024)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T", [1, 5, 40])
def test_overlap_add_plain_matches_pallas_kernel(T):
    frames = np.random.default_rng(T).standard_normal((T, 1024)).astype(np.float32)
    frames *= jstft.hann_window(1024)[None, :]
    ref = np.asarray(jax_overlap_add(jnp.asarray(frames), interpret=True))
    win = torch.from_numpy(tstft.hann_window(1024))
    before = overlap_add.launches
    out = overlap_add(torch.from_numpy(frames), win, 256)
    assert overlap_add.launches == before  # CPU tensors: plain version
    assert out.shape == ref.shape == (1024 + 256 * (T - 1),)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert torch.equal(out, overlap_add_plain(torch.from_numpy(frames), win, 256))


def test_overlap_add_checks():
    win = torch.ones(1024)
    with pytest.raises(ValueError):
        overlap_add(torch.zeros(3, 1024), win, 300)  # hop must divide n_fft
    with pytest.raises(TypeError):
        overlap_add(torch.zeros(3, 1024, dtype=torch.float64), win, 256)
    with pytest.raises(ValueError):
        overlap_add(torch.zeros(3, 1024, device="meta"), win.to("meta"), 256)


@pytest.mark.parametrize("n", [8192, 5000])
def test_stft_istft_match_jax(n):
    y = _signal(n, seed=n)
    jre, jim = jstft.stft_complex(jnp.asarray(y))
    tre, tim = tstft.stft_complex(torch.from_numpy(y))
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=1e-4)
    ref = np.asarray(jstft.istft(jre, jim, length=n + 100))
    out = tstft.istft(torch.tensor(np.asarray(jre)), torch.tensor(np.asarray(jim)),
                      length=n + 100).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    m = 256 * (n // 256)  # the samples the inverse reaches: a round trip
    np.testing.assert_allclose(out[:m], y[:m], atol=1e-4)


def _mel_power(T=24, seed=0):
    r = np.random.default_rng(seed)
    return np.exp(r.uniform(-6.0, 1.0, size=(80, T))).astype(np.float32)


def test_nnls_mel_inverse_matches_jax():
    mp = _mel_power()
    ref = np.asarray(jgl.nnls_mel_inverse(jnp.asarray(mp)))
    out = tgl.nnls_mel_inverse(torch.from_numpy(mp)).numpy()
    assert out.shape == ref.shape == (24, 513)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _jax_phase(T, F, seed=0):
    # exactly what spev_tpu.ops.griffin_lim.griffin_lim draws
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (T, F),
                                        minval=-np.pi, maxval=np.pi))


def test_griffin_lim_same_phase_matches_jax():
    T = 24
    mag = np.sqrt(np.array(jgl.nnls_mel_inverse(jnp.asarray(_mel_power(T)))))
    ref = np.asarray(jgl.griffin_lim(jnp.asarray(mag), n_iter=4, length=256 * T, seed=3))
    before = overlap_add.launches
    out = tgl.griffin_lim(torch.from_numpy(mag), n_iter=4, length=256 * T,
                          init_phase=torch.from_numpy(_jax_phase(T, 513, 3))).numpy()
    assert overlap_add.launches == before
    assert out.shape == ref.shape == (256 * T,)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_mel_to_audio_and_degenerate_input():
    T = 12
    mp = _mel_power(T, seed=1)
    ref = np.asarray(jgl.mel_to_audio(jnp.asarray(mp), n_iter=4, seed=0))
    out = tgl.mel_to_audio(torch.from_numpy(mp), n_iter=4,
                           init_phase=torch.from_numpy(_jax_phase(T, 513, 0))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # seeded phase: deterministic, finite, the requested length
    a = tgl.mel_to_audio(torch.from_numpy(mp), n_iter=2, seed=5)
    b = tgl.mel_to_audio(torch.from_numpy(mp), n_iter=2, seed=5)
    assert torch.equal(a, b) and a.shape == (256 * T,) and torch.isfinite(a).all()
    # fewer frames than one window: silence of the requested length, as in JAX
    short = tgl.griffin_lim(torch.ones(3, 513), length=700)
    assert short.shape == (700,) and not short.any()
    assert np.asarray(jgl.griffin_lim(jnp.ones((3, 513)), length=700)).shape == (700,)
