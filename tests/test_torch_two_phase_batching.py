"""The port's two-phase batched synthesis and request coalescing against the
JAX package on the same numpy weights (a hidden-32 FastSpeech2 and a tiny
HiFi-GAN), on the CPU.

Bars: two-phase rows against JAX's two-phase rows, equal lengths, mel MAE
<= 1e-4 and waveform MAE <= 1e-5 (the port's `synthesize` bars); two-phase
against the port's fused path, mel within 1e-5 and waveform within 1e-4
(JAX's own two-phase test); a coalesced batch of 3 against solo
`synthesize_many`, within 5e-4 (JAX's batcher test), the port's drift
printed."""

import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.infer.synthesis import Synthesizer as JaxSynth
from spev_tpu.infer.vocoder import Vocoder as JaxVocoder
from spev_tpu.models.fastspeech2 import init_fastspeech2
from spev_tpu.models.hifigan import HiFiGANConfig as JaxHCfg
from spev_tpu.models.hifigan import HiFiGANGenerator as JaxGen
from spev_tpu.models.hifigan import init_hifigan
from spev_tpu.text.lexicon import LEXICON
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.infer.batching import _DEFAULTS, CoalescingBatcher
from spev_tpu_torch.infer.synthesis import Synthesizer, pcm16_host
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused
from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree

H, NMEL = 32, 80
SMALL = dict(embed_dim=H, hidden_dim=H, n_mels=NMEL, n_encoder_layers=2, n_decoder_layers=2)
HCFG = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=NMEL)
BUCKETS = dict(g2p_backend="rules", phoneme_buckets=(64,), frame_buckets=(128, 256, 512))
TEXTS = ["hi", "we need to find a new way to bring the music back home", "mid length one", "bye"]


@pytest.fixture(scope="module")
def pair():
    vocab = JaxVocab.build(set("".join(LEXICON.values())))
    jcfg = JaxModelConfig(vocab_size=len(vocab), **SMALL)
    params = init_fastspeech2(jax.random.PRNGKey(0), jcfg)
    # 6 frames per phoneme, far from the round-half-even ties
    params["duration_predictor"]["output_norm"]["bias"] = jnp.asarray([np.log(7.0)])
    params["mel_linear"]["weight"] = params["mel_linear"]["weight"] * 30.0
    params = jax.tree.map(np.asarray, params)
    hparams = jax.tree.map(lambda a: np.asarray(a) * 10.0,
                           init_hifigan(jax.random.PRNGKey(1), JaxHCfg(**HCFG)))
    ckpt = (params, vocab.symbols, {})
    js = JaxSynth(ckpt, model_cfg=jcfg, **BUCKETS)
    js.vocoder = JaxVocoder(generator=JaxGen(JaxHCfg(**HCFG), jax.tree.map(jnp.asarray, hparams)))
    ts = Synthesizer(ckpt, model_cfg=ModelConfig(**SMALL), device="cpu", **BUCKETS)
    gen = HiFiGANGenerator(HiFiGANConfig(**HCFG))
    gen.load_state_dict(hifigan_state_dict_from_tree(hparams, gen.cfg))
    ts.vocoder = Vocoder(generator=gen, device="cpu")
    return js, ts, ckpt


def test_two_phase_matches_jax(pair):
    js, ts, _ = pair
    kw = dict(batch_size=4, two_phase=True, pitch_scale=np.asarray([1.0, 1.2, 0.9, 1.0]),
              breathiness=np.asarray([0.0, 0.4, 0.2, 0.1]))
    jrows, trows = js.synthesize_many(TEXTS, **kw), ts.synthesize_many(TEXTS, **kw)
    lens = set()
    for (jw, jm), (tw, tm) in zip(jrows, trows):
        assert tm.shape == jm.shape and tw.shape == jw.shape == (tm.shape[0] * 256,)
        assert np.abs(tm - jm).mean() <= 1e-4
        assert np.abs(tw - jw).mean() <= 1e-5
        lens.add(-(-tm.shape[0] // 256))
    assert len(lens) > 1  # the rows were vocoded in more than one group


def test_two_phase_matches_fused(pair):
    _, ts, _ = pair
    fused = ts.synthesize_many(TEXTS, batch_size=4, two_phase=False)
    before = lr_fused.launches
    two = ts.synthesize_many(TEXTS, batch_size=4, two_phase=True)
    assert lr_fused.launches == before  # the CPU takes the plain version
    for (w1, m1), (w2, m2) in zip(fused, two):
        assert w1.shape == w2.shape and m1.shape == m2.shape
        np.testing.assert_allclose(m1, m2, atol=1e-5)
        np.testing.assert_allclose(w1, w2, atol=1e-4)


def test_two_phase_want_mel_and_pcm16(pair):
    _, ts, _ = pair
    base = ts.synthesize_many(TEXTS, batch_size=2, two_phase=True)
    out = ts.synthesize_many(TEXTS, batch_size=2, two_phase=True, want_mel=False, pcm16=True)
    for (wf, mf), (wi, mi) in zip(base, out):
        assert mi is None and mf is not None and mf.dtype == np.float32
        assert wi.dtype == np.int16 and wi.shape == wf.shape
        np.testing.assert_array_equal(wi, pcm16_host(wf))


def test_two_phase_refuses_griffin_lim(pair):
    _, ts, ckpt = pair
    gl = Synthesizer(ckpt, model_cfg=ModelConfig(**SMALL), device="cpu", **BUCKETS)
    assert not gl.vocoder.is_neural
    ids = np.zeros((1, 64), np.int32)
    with pytest.raises(ValueError, match="HiFi-GAN"):
        gl.synthesize_batch_two_phase(ids, np.asarray([3], np.int32))


def _solo(ts, text, kw):
    """A batch of one with the controls the batcher gives the request (its
    own over the defaults)."""
    return ts.synthesize_many([text], batch_size=1, **{
        k: np.asarray([v], np.float32) for k, v in {**_DEFAULTS, **kw}.items()})[0]


def _submit_all(batcher, reqs):
    out, errors = [None] * len(reqs), [None] * len(reqs)

    def worker(i):
        try:
            out[i] = batcher.submit(reqs[i][0], timeout=300, **reqs[i][1])
        except Exception as e:  # noqa: BLE001 — handed to the test
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, errors


def test_coalescing_batcher_matches_solo(pair):
    """Three concurrent submits form one batch (padded to 4); each row
    against a solo synthesize_many with the same controls."""
    _, ts, _ = pair
    batcher = CoalescingBatcher(ts, max_batch=4, window_ms=200.0)
    reqs = [("hello there", {"pitch_scale": 1.0}),
            ("good day friend", {"pitch_scale": 1.4, "breathiness": 0.4}),
            ("bye now", {"duration_scale": 1.5})]
    out, errors = _submit_all(batcher, reqs)
    assert errors == [None] * 3
    stats = batcher.stats()
    assert stats.pop("queue_wait_s") >= 0.0
    assert stats == {"max_batch": 4, "batches": 1, "sizes": {"3": 1}, "requests": 3}
    drift = []
    for (text, kw), (wav, mel) in zip(reqs, out):
        s_wav, s_mel = _solo(ts, text, kw)
        assert wav.shape == s_wav.shape and mel.shape == s_mel.shape
        np.testing.assert_allclose(mel, s_mel, atol=5e-4)
        np.testing.assert_allclose(wav, s_wav, atol=5e-4)
        drift.append((float(np.abs(mel - s_mel).max()), float(np.abs(wav - s_wav).max())))
    print("batch of 3 against batch of 1, max |Δ| (mel, wav):", drift)


def test_batcher_isolates_a_failing_request(pair, monkeypatch):
    """A request whose G2P raises fails alone; its batchmates succeed with
    the rows they would get on their own."""
    _, ts, _ = pair
    phonemes = ts.g2p.phonemes

    def g2p(text):
        if "poison" in text:
            raise RuntimeError("g2p failed")
        return phonemes(text)

    monkeypatch.setattr(ts.g2p, "phonemes", g2p)
    batcher = CoalescingBatcher(ts, max_batch=4, window_ms=200.0)
    reqs = [("good morning", {}), ("poison", {"pitch_scale": 1.1}),
            ("see you later", {"duration_scale": 1.2})]
    out, errors = _submit_all(batcher, reqs)
    assert isinstance(errors[1], RuntimeError) and out[1] is None
    assert errors[0] is None and errors[2] is None
    for i in (0, 2):
        text, kw = reqs[i]
        s_wav, s_mel = _solo(ts, text, kw)
        np.testing.assert_allclose(out[i][1], s_mel, atol=5e-4)
        np.testing.assert_allclose(out[i][0], s_wav, atol=5e-4)


def test_batcher_stress_many_threads(pair):
    """More submitting threads than cores, with a short switch interval:
    every caller gets its own row (the length of its text alone) and the
    batch sizes the worker reports add up to the requests."""
    import os
    import sys

    _, ts, _ = pair
    texts = ["hi", "bye", "mid length one", "good day friend", "see you later"]
    solo = {t: _solo(ts, t, {})[1].shape for t in texts}
    n = 2 * (os.cpu_count() or 4) + 3
    reqs = [(texts[i % len(texts)], {}) for i in range(n)]
    batcher = CoalescingBatcher(ts, max_batch=4, window_ms=2.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, errors = _submit_all(batcher, reqs)
    finally:
        sys.setswitchinterval(old)
    assert errors == [None] * n and all(r is not None for r in out)
    for (text, _), (wav, mel) in zip(reqs, out):
        assert mel.shape == solo[text] and wav.shape == (mel.shape[0] * 256,)
    stats = batcher.stats()
    assert sum(int(k) * v for k, v in stats["sizes"].items()) == n == stats["requests"]
    assert stats["batches"] == sum(stats["sizes"].values())
    assert max(int(k) for k in stats["sizes"]) <= 4
