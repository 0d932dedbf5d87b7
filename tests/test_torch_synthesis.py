"""The PyTorch port's Synthesizer against spev_tpu.infer.synthesis.Synthesizer
on the same (params, vocab, stats) tuple and the same small HiFi-GAN: the
same ids, equal mel_len, mel within 1e-4 MAE and waveform within 1e-5 MAE for
synthesize, over-bucket text and synthesize_many; on the Griffin-Lim path
(whose random phase cannot match JAX's bits) mel, mel_len and length only."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

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
from spev_tpu_torch.infer.synthesis import Synthesizer, pcm16_host
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.ops.cuda.kernels import overlap_add
from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused
from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree

H, NMEL = 32, 80
SMALL = dict(embed_dim=H, hidden_dim=H, n_mels=NMEL, n_encoder_layers=2, n_decoder_layers=2)
HCFG = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=NMEL)
BUCKETS = dict(g2p_backend="rules", phoneme_buckets=(32, 64), frame_buckets=(128, 256, 512))
TEXTS = ["one two", "a much longer line of text here", "mid length text", "bye now"]
LONG = ("one clause here, and another clause, then more words after that, "
        "and still further clauses keep arriving here")


@pytest.fixture(scope="module")
def pair():
    vocab = JaxVocab.build(set("".join(LEXICON.values())))
    jcfg = JaxModelConfig(vocab_size=len(vocab), **SMALL)
    params = init_fastspeech2(jax.random.PRNGKey(0), jcfg)
    # 6 frames per phoneme, far from the round-half-even ties
    params["duration_predictor"]["output_norm"]["bias"] = jnp.asarray([np.log(7.0)])
    params["pitch_predictor"]["output_norm"]["bias"] = jnp.asarray([0.5])
    params["mel_linear"]["weight"] = params["mel_linear"]["weight"] * 30.0
    params = jax.tree.map(np.asarray, params)
    hparams = jax.tree.map(lambda a: np.asarray(a) * 10.0,
                           init_hifigan(jax.random.PRNGKey(1), JaxHCfg(**HCFG)))
    ckpt = (params, vocab.symbols, {"p_mean": 0.0})

    js = JaxSynth(ckpt, model_cfg=jcfg, **BUCKETS)
    js.vocoder = JaxVocoder(generator=JaxGen(JaxHCfg(**HCFG), jax.tree.map(jnp.asarray, hparams)))
    ts = Synthesizer(ckpt, model_cfg=ModelConfig(**SMALL), device="cpu", **BUCKETS)
    gen = HiFiGANGenerator(HiFiGANConfig(**HCFG))
    gen.load_state_dict(hifigan_state_dict_from_tree(hparams, gen.cfg))
    ts.vocoder = Vocoder(generator=gen, device="cpu")
    return js, ts, ckpt


def _close(jrow, trow):
    (jw, jm), (tw, tm) = jrow, trow
    assert tm.shape == jm.shape and tw.shape == jw.shape
    assert np.abs(tm - jm).mean() < 1e-4
    assert np.abs(tw - jw).mean() < 1e-5


def test_same_ids(pair):
    js, ts, ckpt = pair
    for text in TEXTS + [LONG]:
        np.testing.assert_array_equal(ts.phonemes_to_ids(ts.g2p.phonemes(text)),
                                      js.phonemes_to_ids(js.g2p.phonemes(text)))


def test_synthesize_matches_jax(pair):
    js, ts, ckpt = pair
    before = (lr_fused.launches, overlap_add.launches)
    for kw in (dict(), dict(breathiness=0.4, roughness=0.2, brightness=0.5,
                            pitch_scale=1.1, duration_scale=0.8)):
        jrow, trow = js.synthesize(TEXTS[1], **kw), ts.synthesize(TEXTS[1], **kw)
        _close(jrow, trow)
        assert trow[0].shape[0] == trow[1].shape[0] * 256
    assert ts._fpp == pytest.approx(js._fpp)
    assert (lr_fused.launches, overlap_add.launches) == before  # CPU: no kernel launch


def test_vocoder_infer_pads_to_a_bucket(pair):
    js, ts, _ = pair
    mel = np.random.default_rng(4).uniform(-8.0, 1.0, size=(150, NMEL)).astype(np.float32)
    ref = np.asarray(js.vocoder.infer(mel))
    out = ts.vocoder.infer(mel)
    assert out.shape == ref.shape == (150 * 256,)
    assert np.abs(out - ref).mean() < 1e-5


def test_over_bucket_text_is_chunked(pair):
    js, ts, ckpt = pair
    assert len(ts.phonemes_to_ids(ts.g2p.phonemes(LONG))) > 64
    _close(js.synthesize(LONG), ts.synthesize(LONG))


def test_synthesize_many_matches_jax(pair):
    js, ts, ckpt = pair
    kw = dict(batch_size=2, duration_scale=np.asarray([1.0, 1.3, 0.7, 1.0]),
              breathiness=np.asarray([0.0, 0.5, 0.2, 0.1]))
    jrows, trows = js.synthesize_many(TEXTS, **kw), ts.synthesize_many(TEXTS, **kw)
    assert len(trows) == len(TEXTS)
    for jrow, trow in zip(jrows, trows):
        _close(jrow, trow)
    # a long text takes the chunked route (synthesize's default qualities)
    (_, m_long), = ts.synthesize_many([LONG], batch_size=2, breathiness=0.1,
                                      roughness=0.05, brightness=0.0)
    np.testing.assert_allclose(m_long, ts.synthesize(LONG)[1], atol=1e-5)
    # pcm16 on the device and no mel: the host conversion of the float run
    ints = ts.synthesize_many(TEXTS, want_mel=False, pcm16=True, **kw)
    for (wf, _), (wi, mi) in zip(trows, ints):
        assert mi is None and wi.dtype == np.int16
        np.testing.assert_array_equal(wi, pcm16_host(wf))
    with pytest.raises(ValueError, match="per-request"):
        ts.synthesize_many(TEXTS, duration_scale=np.asarray([1.0, 2.0]))


def test_griffin_lim_path(pair):
    js, ts, ckpt = pair
    # the port's own state dict is a checkpoint too
    sd_ckpt = (ts.model.state_dict(), ts.vocab.symbols, ts.stats)
    gl = Synthesizer(sd_ckpt, model_cfg=ModelConfig(**SMALL), device="cpu", **BUCKETS)
    assert not gl.vocoder.is_neural
    jgl = JaxSynth(ckpt, model_cfg=js.model_cfg, hifigan_dir=None, **BUCKETS)
    (jw, jm), (tw, tm) = jgl.synthesize(TEXTS[0]), gl.synthesize(TEXTS[0])
    assert tm.shape == jm.shape and tw.shape == jw.shape == (tm.shape[0] * 256,)
    assert np.abs(tm - jm).mean() < 1e-4
    assert np.isfinite(tw).all()
    (w16, m16), = gl.synthesize_many([TEXTS[0]], want_mel=False, pcm16=True)
    assert m16 is None and w16.dtype == np.int16 and w16.shape == tw.shape


def test_reference_pt_and_cli(pair, tmp_path):
    from spev_tpu.train.checkpoint import export_reference_checkpoint
    from spev_tpu_torch.cli.infer import main

    js, ts, ckpt = pair
    path = str(tmp_path / "model.pt")
    export_reference_checkpoint(path, ckpt[0], ckpt[1], ckpt[2])
    from_pt = Synthesizer(path, model_cfg=ModelConfig(**SMALL), device="cpu", **BUCKETS)
    from_pt.vocoder = ts.vocoder
    np.testing.assert_array_equal(from_pt.synthesize(TEXTS[3])[1], ts.synthesize(TEXTS[3])[1])
    # user errors exit 2 with one line
    assert main(["--checkpoint", str(tmp_path / "missing.pt"), "--device", "cpu"]) == 2
    (tmp_path / "x.spev").write_bytes(b"")
    assert main(["--checkpoint", str(tmp_path / "x.spev"), "--device", "cpu"]) == 2

