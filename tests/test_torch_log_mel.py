"""The port's log-mel against the JAX package's, on the CPU: the port's
`fused_log_mel` (on CPU tensors its plain version, K2's oracle) against the
JAX `log_mel_spectrogram` and `fused_log_mel` (the Pallas kernel in interpret
mode), within 2e-4 absolute, the JAX package's own bar for its kernel.  The signals are those of tests/test_pallas_kernels.py
plus one whose length is a multiple of the dataset's 8192-sample bucket; fmax
is the serving path's 8000 Hz and the dataset build's sr/2."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spev_tpu.ops.pallas.kernels import fused_log_mel as jax_fused_log_mel
from spev_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, fused_log_mel_plain

TOL = 2e-4


def _signal(n, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * r.standard_normal(n)).astype(np.float32)


CASES = [(22050, 0), (5000, 1), (3 * 8192, 2)]


@pytest.mark.parametrize("fmax", [8000.0, 11025.0], ids=["fmax8000", "fmax_sr_half"])
@pytest.mark.parametrize("n,seed", CASES, ids=[f"n{n}" for n, _ in CASES])
def test_log_mel_matches_jax(n, seed, fmax):
    y = _signal(n, seed)
    ref = np.asarray(jax_log_mel(jnp.asarray(y), fmax=fmax))
    ref_kernel = np.asarray(jax_fused_log_mel(jnp.asarray(y), fmax=fmax, interpret=True))
    fused = fused_log_mel(torch.from_numpy(y), fmax=fmax).numpy()
    assert fused.shape == ref.shape == (80, 1 + n // 256)
    # the comparison means something only where the values are not clipped
    assert (ref > -10.0).mean() > 0.9
    np.testing.assert_allclose(fused, ref, atol=TOL)
    np.testing.assert_allclose(fused, ref_kernel, atol=TOL)


def test_fused_log_mel_takes_plain_version_on_cpu():
    y = torch.from_numpy(_signal(8192, 3))
    before = fused_log_mel.launches
    out = fused_log_mel(y, fmax=11025.0)
    assert torch.equal(out, fused_log_mel_plain(y, fmax=11025.0))
    assert fused_log_mel.launches == before and out.is_contiguous()


def test_fused_log_mel_argument_errors():
    y = torch.from_numpy(_signal(4096, 4))
    with pytest.raises(ValueError, match="1-D"):
        fused_log_mel(y[None])
    with pytest.raises(TypeError, match="float32"):
        fused_log_mel(y.double())
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_log_mel(y, n_fft=1022)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_log_mel(y, n_fft=2048)
    with pytest.raises(ValueError, match="too few"):
        fused_log_mel(y[:512])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_log_mel(torch.empty(4096, device="meta"))
