"""The port's streaming synthesis against the JAX package on the CPU:
receptive fields equal, clause splits equal, `stream_vocode` chunks of JAX's
count and lengths whose samples are JAX's full HiFi-GAN pass (MAE <= 1e-5)
and the port's own full pass (within 1e-4, JAX's bar) past one receptive
field, and `stream_text` against per-clause synthesis.  The generator's
weights are ten times JAX's initialisation, so the waveform is far from
zero."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.infer import streaming as jax_streaming
from spev_tpu.infer.synthesis import Synthesizer as JaxSynth
from spev_tpu.infer.vocoder import Vocoder as JaxVocoder
from spev_tpu.models.fastspeech2 import init_fastspeech2
from spev_tpu.models.hifigan import HiFiGANConfig as JaxHCfg
from spev_tpu.models.hifigan import HiFiGANGenerator as JaxGen
from spev_tpu.models.hifigan import apply_hifigan, init_hifigan
from spev_tpu.text.lexicon import LEXICON
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.infer import streaming
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree

H, NMEL = 32, 8
TINY = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=NMEL)
CLAUSE_TEXTS = [
    "Hello there, my friend. How are you today? Good.",
    "short",
    "",
    "   spaced   out   words   ",
    "one; two: three, four! five? six.",
    "No punctuation at all in this rather long sentence",
    "A, b, c, d, e, f, g.",
    "Well... that was odd!! Really?!",
    "Numbers 1, 2 and 3.5 are here, then more text follows.",
    "Ends with a comma,",
    "Trailing clause that is short. ok",
]


@pytest.fixture(scope="module")
def gens():
    cfg = JaxHCfg(**TINY)
    params = jax.tree.map(lambda a: np.asarray(a) * 10.0, init_hifigan(jax.random.PRNGKey(0), cfg))
    jgen = JaxGen(cfg, jax.tree.map(jnp.asarray, params))
    tgen = HiFiGANGenerator(HiFiGANConfig(**TINY))
    tgen.load_state_dict(hifigan_state_dict_from_tree(params, tgen.cfg))
    return jgen, tgen.eval()


@pytest.mark.parametrize("name", ["v1", "v3", "tiny"])
def test_receptive_field_equals_jax(name):
    jcfg, tcfg = {"v1": (JaxHCfg(), HiFiGANConfig()), "v3": (JaxHCfg.v3(), HiFiGANConfig.v3()),
                  "tiny": (JaxHCfg(**TINY), HiFiGANConfig(**TINY))}[name]
    rf = streaming.receptive_field_frames(tcfg)
    assert rf == jax_streaming.receptive_field_frames(jcfg)
    assert 4 <= rf <= 64


@pytest.mark.parametrize("text", CLAUSE_TEXTS)
def test_split_clauses_equals_jax(text):
    assert streaming.split_clauses(text) == jax_streaming.split_clauses(text)
    assert streaming.split_clauses(text, 4) == jax_streaming.split_clauses(text, 4)


def _mel(T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, NMEL)) - 4.0).astype(np.float32)


def test_stream_vocode_matches_jax(gens):
    """JAX's chunk count and lengths; the samples against JAX's full pass
    past one receptive field (JAX's own windows lack right context, so its
    chunk ends are not a full pass: the port adds it)."""
    jgen, tgen = gens
    T, hop = 70, tgen.cfg.hop_recovery
    mel = _mel(T)
    full = np.asarray(apply_hifigan(jgen.params, jgen.cfg, jnp.asarray(mel)[None])[0])
    rf = streaming.receptive_field_frames(tgen.cfg) * hop
    for chunk, ctx in ((16, None), (32, 24)):
        jchunks = list(jax_streaming.stream_vocode(jgen, jnp.asarray(mel), chunk_frames=chunk,
                                                   context_frames=ctx))
        tchunks = list(streaming.stream_vocode(tgen, mel, chunk_frames=chunk, context_frames=ctx))
        assert [len(c) for c in tchunks] == [len(c) for c in jchunks]
        assert all(c.dtype == np.float32 for c in tchunks)
        streamed = np.concatenate(tchunks)
        assert np.abs(streamed[rf:] - full[rf : T * hop]).mean() <= 1e-5


def test_stream_matches_full_pass(gens):
    _, tgen = gens
    T = 70
    mel = _mel(T, seed=1)
    with torch.inference_mode():
        full = tgen(torch.from_numpy(mel)[None])[0].numpy()
    streamed = np.concatenate(list(streaming.stream_vocode(tgen, mel, chunk_frames=16)))
    hop = tgen.cfg.hop_recovery
    assert streamed.shape[0] == T * hop
    rf = streaming.receptive_field_frames(tgen.cfg) * hop
    np.testing.assert_allclose(streamed[rf:], full[rf : T * hop], atol=1e-4)


def test_chunk_lengths(gens):
    _, tgen = gens
    chunks = list(streaming.stream_vocode(tgen, np.zeros((33, NMEL), np.float32) - 4.0,
                                          chunk_frames=16))
    hop = tgen.cfg.hop_recovery
    assert [len(c) for c in chunks] == [16 * hop, 16 * hop, 1 * hop]


def test_stream_text_is_per_clause_synthesis():
    vocab = JaxVocab.build(set("".join(LEXICON.values())))
    small = dict(embed_dim=H, hidden_dim=H, n_mels=80, n_encoder_layers=2, n_decoder_layers=2)
    jcfg = JaxModelConfig(vocab_size=len(vocab), **small)
    params = init_fastspeech2(jax.random.PRNGKey(0), jcfg)
    params["duration_predictor"]["output_norm"]["bias"] = jnp.asarray([np.log(7.0)])
    params["mel_linear"]["weight"] = params["mel_linear"]["weight"] * 30.0
    params = jax.tree.map(np.asarray, params)
    hcfg = dict(TINY, num_mels=80)
    hparams = jax.tree.map(lambda a: np.asarray(a) * 10.0,
                           init_hifigan(jax.random.PRNGKey(1), JaxHCfg(**hcfg)))
    ckpt = (params, vocab.symbols, {})
    buckets = dict(g2p_backend="rules", phoneme_buckets=(64,), frame_buckets=(256, 512))
    js = JaxSynth(ckpt, model_cfg=jcfg, **buckets)
    js.vocoder = JaxVocoder(generator=JaxGen(JaxHCfg(**hcfg), jax.tree.map(jnp.asarray, hparams)))
    ts = Synthesizer(ckpt, model_cfg=ModelConfig(**small), device="cpu", **buckets)
    gen = HiFiGANGenerator(HiFiGANConfig(**hcfg))
    gen.load_state_dict(hifigan_state_dict_from_tree(hparams, gen.cfg))
    ts.vocoder = Vocoder(generator=gen, device="cpu")

    text = "Hello there, my friend. How are you today? Good."
    controls = dict(pitch_scale=1.1, breathiness=0.3)
    clauses = streaming.split_clauses(text)
    assert len(clauses) > 1
    tstream = list(streaming.stream_text(ts, text, **controls))
    jstream = list(jax_streaming.stream_text(js, text, **controls))
    assert len(tstream) == len(jstream) == len(clauses)
    for clause, t, j in zip(clauses, tstream, jstream):
        np.testing.assert_array_equal(t, ts.synthesize(clause, **controls)[0])
        assert t.shape == np.asarray(j).shape
        assert np.abs(t - np.asarray(j)).mean() <= 1e-5
