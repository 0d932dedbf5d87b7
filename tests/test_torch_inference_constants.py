"""The device constants of ``ops.stft`` (Hann window, DFT and mel bases)
serve autograd whatever mode first made them.

Serving, evaluation and Griffin-Lim run under ``torch.inference_mode()``.
When such a call is the first to need a constant, the cached tensor must
still be usable by a later backward in the same process: the GAN step's
mel L1, a fine-tuning run after a request.  Each test clears the cache
first, so its result does not depend on what ran before it in the worker.
"""

import numpy as np
import pytest
import torch

from spev_tpu_torch.models.hifigan import HiFiGANConfig
from spev_tpu_torch.ops import stft
from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
from spev_tpu_torch.ops.griffin_lim import mel_to_audio
from spev_tpu_torch.train import vocoder_trainer as vt

TINY = HiFiGANConfig(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                     upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                     resblock_dilation_sizes=((1, 2),), num_mels=80)


def _serve_first():
    """Empty the cache, then make its constants the way serving does: a
    Griffin-Lim vocoding and K2's plain path under inference mode."""
    stft._CONSTANTS.clear()
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        mel_power = torch.from_numpy(np.exp(rng.standard_normal((80, 40)) - 5.0).astype(np.float32))
        wav = mel_to_audio(mel_power, n_iter=2)
        fused_log_mel(wav.contiguous())
    assert stft._CONSTANTS, "the serving calls made no device constant"


def test_constants_are_normal_tensors_after_inference_mode():
    _serve_first()
    assert not any(t.is_inference() for t in stft._CONSTANTS.values())


def test_mel_l1_backward_after_serving():
    _serve_first()
    rng = np.random.default_rng(1)
    y = torch.tensor(0.3 * rng.standard_normal((2, 4096)), dtype=torch.float32,
                     requires_grad=True)
    target = stft.log_mel_spectrogram(torch.zeros_like(y).detach() + 0.01)
    loss = torch.mean(torch.abs(stft.log_mel_spectrogram(y) - target))
    loss.backward()
    g_after = y.grad.clone()
    # the same gradient from constants made in a fresh cache, outside
    # inference mode
    stft._CONSTANTS.clear()
    y.grad = None
    torch.mean(torch.abs(stft.log_mel_spectrogram(y) - target)).backward()
    assert torch.isfinite(g_after).all()
    torch.testing.assert_close(g_after, y.grad, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_vocoder_train_step_after_serving(fused):
    _serve_first()
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((2, 8, 80)).astype(np.float32) - 6.0)
    wav = torch.from_numpy((0.3 * rng.standard_normal((2, 8 * 256))).astype(np.float32))
    state = vt.init_vocoder_train_state(TINY, periods=(2,), n_scales=1, device="cpu")
    before = [p.detach().clone() for p in state.generator.parameters()]
    state, m = vt.VocoderTrainStep(TINY, fused=fused)(state, mel, wav)
    assert m["skipped"] == 0.0 and np.isfinite(m["g_mel"])
    assert state.step == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, state.generator.parameters()))
