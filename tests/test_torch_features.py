"""The port's frame features against the JAX package's, on the CPU, on the
signals of tests/test_pyin.py (a tone, a glide, noise, a breathy tone; all
0.5 s, so each JAX tracker compiles once per hop):

- RMS and spectral centroid within 1e-5 relative, CMNDF within 1e-5
  absolute on the lags the trackers read (the same float32 steps; sums
  taken in another order);
- `pyin_f0` and `yin_f0` at hop 256 (the per-file pass) and 512 (the stats
  pass): ``voiced_prob`` within 5e-4 (test_pyin.py's bar against its librosa
  oracle), ``voiced_flag`` equal on every frame, and pyin's decoded bin
  frequency equal on every frame (yin's interpolated f0 within 1e-5
  relative);
- the pyin lattice equal; the Viterbi's state path equal to JAX's scan where
  the scores tie (first maximal index on both sides);
- `f0_rmse_hz` within 1e-3 Hz.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spev_tpu.diag.quality import f0_rmse_hz as jax_f0_rmse
from spev_tpu.ops import features as jf
from spev_tpu_torch.diag.quality import f0_rmse_hz
from spev_tpu_torch.ops import features as tf

SR = 22050
N = int(0.5 * SR)


def _signals():
    t = np.arange(N) / SR
    glide_f0 = 150.0 * 2 ** (t / 0.5)
    rng = np.random.RandomState(3)
    silence_tone = np.zeros(N)
    silence_tone[N // 3 : 2 * N // 3] = np.sin(2 * np.pi * 180 * t[: N // 3])
    return {
        "tone": np.sin(2 * np.pi * 220.0 * t),
        "glide": np.sin(2 * np.pi * np.cumsum(glide_f0) / SR),
        "noise": 0.1 * np.random.RandomState(0).randn(N),
        "breathy": 0.4 * np.sin(2 * np.pi * 200 * t) + 0.6 * rng.randn(N),
        # exact silence: every unvoiced state's score ties
        "silence_tone": silence_tone,
    }


SIGNALS = {k: v.astype(np.float32) for k, v in _signals().items()}


@functools.lru_cache(maxsize=None)
def _jax_tracker(name, hop):
    fn = jf.pyin_f0 if name == "pyin" else jf.yin_f0
    return jax.jit(lambda x: fn(x, sr=SR, hop_length=hop))


@pytest.mark.parametrize("name", ["tone", "breathy"])
def test_rms_and_centroid_match_jax(name):
    y = SIGNALS[name]
    rms = tf.rms_energy(torch.from_numpy(y)).numpy()
    cent = tf.spectral_centroid(torch.from_numpy(y), sr=SR).numpy()
    np.testing.assert_allclose(rms, np.asarray(jf.rms_energy(jnp.asarray(y))), rtol=1e-5)
    np.testing.assert_allclose(cent, np.asarray(jf.spectral_centroid(jnp.asarray(y), sr=SR)),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["glide", "noise"])
def test_cmndf_matches_jax(name):
    """Within 1e-5 on the lags the trackers read (tau_min = 44 .. 368).  At
    the first few lags of a periodic frame d(tau) is a small difference of
    sums near 256 and d'(tau) a ratio of such differences: there the two
    float32 evaluations (other FFTs, other cumsum orders) differ by up to
    ~7e-5, and each lies within 1e-4 of the same formula in float64."""
    y = np.pad(SIGNALS[name], 1024)
    frames = np.lib.stride_tricks.sliding_window_view(y, 2048)[::256].copy()
    ours = tf._cmndf(torch.from_numpy(frames), 368, 1024).numpy()
    ref = np.asarray(jf._cmndf(jnp.asarray(frames), 368, 1024))
    exact = tf._cmndf(torch.from_numpy(frames.astype(np.float64)), 368, 1024).numpy()
    assert ours.shape == ref.shape == (frames.shape[0], 369)
    np.testing.assert_allclose(ours[:, 44:], ref[:, 44:], atol=1e-5)
    np.testing.assert_allclose(ours, exact, atol=1e-4)
    np.testing.assert_allclose(ref, exact, atol=1e-4)


@pytest.mark.parametrize("hop", [256, 512])
@pytest.mark.parametrize("name", sorted(SIGNALS))
@pytest.mark.parametrize("tracker", ["pyin", "yin"])
def test_f0_trackers_match_jax(tracker, name, hop):
    y = SIGNALS[name]
    jf0, jvf, jvp = map(np.asarray, _jax_tracker(tracker, hop)(jnp.asarray(y)))
    fn = tf.pyin_f0 if tracker == "pyin" else tf.yin_f0
    f0, vf, vp = (a.numpy() for a in fn(torch.from_numpy(y), sr=SR, hop_length=hop))
    assert f0.shape == vf.shape == vp.shape == jf0.shape == (1 + N // hop,)
    assert np.max(np.abs(vp - jvp)) < 5e-4
    np.testing.assert_array_equal(vf, jvf)
    np.testing.assert_array_equal(np.isnan(f0), ~vf)
    if tracker == "pyin":
        np.testing.assert_array_equal(f0[vf], jf0[vf])  # the same bin on every voiced frame
    else:
        np.testing.assert_allclose(f0[vf], jf0[vf], rtol=1e-5)
    if name in ("tone", "glide"):
        assert vf[4:-4].all()
    if name == "noise":
        assert vf.mean() < 0.1


@pytest.mark.parametrize("hop", [256, 512])
def test_pyin_lattice_equal(hop):
    args = (SR, 60.0, 500.0, hop, 10, 35.92, 0.01)
    ours, ref = tf._pyin_lattice(*args), jf._pyin_lattice(*args)
    assert ours[0] == ref[0] == 368
    for a, b in zip(ours[1:], ref[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_viterbi(log_obs, log_trans, log_init):
    """The forward scan and backtrace of `spev_tpu.ops.features.pyin_f0`."""

    def fwd(carry, ob):
        scores = carry[:, None] + log_trans
        return jnp.max(scores, axis=0) + ob, jnp.argmax(scores, axis=0).astype(jnp.int32)

    final, ptrs = jax.lax.scan(fwd, log_init + log_obs[0], log_obs[1:])
    first, tail = jax.lax.scan(lambda s, p: (p[s], s), jnp.argmax(final).astype(jnp.int32),
                               ptrs, reverse=True)
    return np.asarray(jnp.concatenate([first[None], tail]))


def test_viterbi_ties_resolve_as_in_jax():
    n_bins, _, log_trans, log_init = tf._pyin_lattice(SR, 60.0, 500.0, 256, 10, 35.92, 0.01)
    rng = np.random.default_rng(5)
    n = 24
    obs = np.zeros((n, 2 * n_bins), np.float32)
    obs[:, n_bins:] = 1.0 / n_bins  # every unvoiced state ties on every frame
    obs[8:14, 100:104] = 0.9  # four voiced bins tie on a run of frames
    obs[15, : n_bins] = rng.uniform(0.0, 1e-3, n_bins)
    obs[20] = 0.0  # a frame where every observation is 0 (log -inf)
    with np.errstate(divide="ignore"):
        log_obs = np.log(obs)
    ours = tf._viterbi(torch.from_numpy(log_obs), torch.from_numpy(log_trans),
                       torch.from_numpy(log_init))
    ref = _jax_viterbi(jnp.asarray(log_obs), jnp.asarray(log_trans), jnp.asarray(log_init))
    np.testing.assert_array_equal(ours, ref)
    # the tied voiced run takes the first of its four bins, and from the
    # frame where every score is -inf on, state 0
    assert (ours[8:14] == 100).all() and (ours[20:] == 0).all()


def test_f0_rmse_matches_jax():
    a, b = SIGNALS["tone"], SIGNALS["glide"]
    ours = f0_rmse_hz(a, b, sr=SR, device="cpu")
    ref = jax_f0_rmse(a, b, sr=SR)
    assert np.isfinite(ref) and ref > 10.0
    assert abs(ours - ref) < 1e-3
    assert np.isnan(f0_rmse_hz(SIGNALS["noise"], SIGNALS["noise"], sr=SR, device="cpu"))
