"""The PyTorch port's advanced surface against the JAX package: the VAD /
speaker / emphasis forward, the age and lung rules, emphasis parsing and
per-word phonemes, the prosody tables, breath planning, the block IIR
filters, the mel-domain DSP and the vocal events (with JAX's noise fed to
both sides), and ``synthesize_advanced_controls`` end to end on a tiny
``.spev`` that JAX wrote; then ``cli.spev_advanced`` in-process."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.signal
import torch

from spev_tpu.agents import breath as jax_breath
from spev_tpu.agents import prosody as jax_prosody
from spev_tpu.agents.events import VocalEventSynth as JaxEvents
from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.infer.advanced_api import synthesize_advanced_controls as jax_controls
from spev_tpu.infer.synthesis import Synthesizer as JaxSynth
from spev_tpu.infer.vocoder import Vocoder as JaxVocoder
from spev_tpu.models import advanced as jax_adv
from spev_tpu.models.hifigan import HiFiGANConfig as JaxHCfg
from spev_tpu.models.hifigan import HiFiGANGenerator as JaxGen
from spev_tpu.models.hifigan import init_hifigan
from spev_tpu.ops import filters as jax_filters
from spev_tpu.ops import mel_dsp as jax_dsp
from spev_tpu.text import emphasis as jax_emph
from spev_tpu.text.g2p import G2P as JaxG2P
from spev_tpu.text.lexicon import LEXICON
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.checkpoint import model_config_dict, save_checkpoint
from spev_tpu_torch.agents import breath, prosody
from spev_tpu_torch.agents.events import VocalEventSynth
from spev_tpu_torch.cli.spev_advanced import main as cli_main
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.infer.advanced_api import synthesize_advanced_controls
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models import advanced as adv
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.ops import filters, mel_dsp
from spev_tpu_torch.text import emphasis
from spev_tpu_torch.text.g2p import G2P
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree, hifigan_state_dict_from_tree

H, NMEL = 32, 80
SMALL = dict(embed_dim=H, hidden_dim=H, n_mels=NMEL, n_encoder_layers=2, n_decoder_layers=2)
ADV = dict(use_vad=True, use_nasality=True, n_speakers=4, vp_output_norm=False)
HCFG = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=NMEL)
BUCKETS = dict(g2p_backend="rules", phoneme_buckets=(32, 64), frame_buckets=(128, 256, 512))
TEXT = "first phrase here, second phrase follows, third phrase ends now"
CONTROLS = dict(breathiness=0.3, roughness=0.2, nasality=0.4, valence=-0.5, arousal=0.6,
                dominance=-0.3, age=60.0, speaker=2, word_emphasis="1,1.5,1,2")


def _jax_params(seed=0):
    """A tiny advanced + nasality tree: per-phoneme predictors with ~6
    frames a phoneme from the duration proj bias, a nonzero VAD projection."""
    vocab = JaxVocab.build(set("".join(LEXICON.values())))
    jcfg = JaxModelConfig(vocab_size=len(vocab), **SMALL, **ADV)
    params = jax.tree.map(np.asarray, jax_adv.init_advanced(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    dp = params["duration_predictor"]["proj"]
    dp["weight"] = (dp["weight"] * 0.05).astype(np.float32)
    dp["bias"] = np.asarray([np.log(7.0)], np.float32)
    params["pitch_predictor"]["proj"]["bias"] = np.asarray([0.5], np.float32)
    params["mel_linear"]["weight"] = params["mel_linear"]["weight"] * 30.0
    params["advanced"]["vad_proj"]["weight"] = rng.normal(0, 0.5, (H, 3)).astype(np.float32)
    params["advanced"]["vad_proj"]["bias"] = rng.normal(0, 0.1, (H,)).astype(np.float32)
    return jcfg, params, vocab


@pytest.fixture(scope="module")
def spev_path(tmp_path_factory):
    jcfg, params, vocab = _jax_params()
    path = str(tmp_path_factory.mktemp("adv") / "adv.spev")
    save_checkpoint(path, params, vocab=vocab.symbols, stats={}, model_config=model_config_dict(jcfg))
    return path


@pytest.fixture(scope="module")
def hifigan():
    hparams = jax.tree.map(lambda a: np.asarray(a) * 10.0,
                           init_hifigan(jax.random.PRNGKey(1), JaxHCfg(**HCFG)))
    gen = HiFiGANGenerator(HiFiGANConfig(**HCFG))
    gen.load_state_dict(hifigan_state_dict_from_tree(hparams, gen.cfg))
    return (JaxVocoder(generator=JaxGen(JaxHCfg(**HCFG), jax.tree.map(jnp.asarray, hparams))),
            Vocoder(generator=gen, device="cpu"))


def _jax_normal(seed_or_key, shape):
    key = jax.random.PRNGKey(seed_or_key) if isinstance(seed_or_key, int) else seed_or_key
    return torch.as_tensor(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's two noise sources replay JAX's draws: `dsp_noise` the
    PRNGKey(seed) normal, `VocalEventSynth._noise` the split chain of
    PRNGKey(0) (the default dsp_seed)."""
    monkeypatch.setattr(mel_dsp, "dsp_noise",
                        lambda shape, seed, device: _jax_normal(seed, shape).to(device))

    def events_noise(self, n):
        key, sub = jax.random.split(self.__dict__.get("_jax_key", jax.random.PRNGKey(0)))
        self._jax_key = key
        return _jax_normal(sub, (n,)).to(self.device)

    monkeypatch.setattr(VocalEventSynth, "_noise", events_noise)


# -- the model --------------------------------------------------------------


def test_apply_advanced_matches_jax():
    jcfg, params, _ = _jax_params(seed=3)
    B, P, M = 2, 16, 256
    rng = np.random.default_rng(3)
    ids = np.zeros((B, P), np.int32)
    ids[0, :12] = rng.integers(3, jcfg.vocab_size, 12)
    ids[1, :9] = rng.integers(3, jcfg.vocab_size, 9)
    lens = np.asarray([12, 9], np.int32)
    vad = np.asarray([[-0.5, 0.6, -0.3], [0.4, -0.2, 0.9]], np.float32)
    spk = np.asarray([2, 0], np.int32)
    emph = np.where(rng.random((B, P)) < 0.3, 1.5, 1.0).astype(np.float32)
    nasal = rng.uniform(0, 1, (B, P)).astype(np.float32)
    cfg_m = dataclasses.replace(jcfg, max_phonemes=P, max_frames=M)
    ref = jax_adv.apply_advanced(jax.tree.map(jnp.asarray, params), cfg_m, jnp.asarray(ids), jnp.asarray(lens),
                                 vad=jnp.asarray(vad), speaker_ids=jnp.asarray(spk),
                                 emphasis=jnp.asarray(emph), target_nasal=jnp.asarray(nasal),
                                 p_control=1.1)
    model = FastSpeech2(ModelConfig(vocab_size=jcfg.vocab_size, **SMALL, **ADV))
    model.load_state_dict(fastspeech2_state_dict_from_tree(params))
    with torch.no_grad():
        out = adv.apply_advanced(model.eval(), torch.as_tensor(ids, dtype=torch.long),
                                 torch.as_tensor(lens), M, vad=torch.as_tensor(vad),
                                 speaker_ids=torch.as_tensor(spk, dtype=torch.long),
                                 emphasis=torch.as_tensor(emph), target_nasal=torch.as_tensor(nasal),
                                 p_control=1.1)
    np.testing.assert_array_equal(out["mel_len"].numpy(), np.asarray(ref["mel_len"]))
    assert np.abs(out["mel_pred"].numpy() - np.asarray(ref["mel_pred"])).mean() < 1e-4
    # VAD and speaker each move the output
    with torch.no_grad():
        plain = adv.apply_advanced(model, torch.as_tensor(ids, dtype=torch.long),
                                   torch.as_tensor(lens), M)
    assert not torch.equal(plain["mel_pred"], out["mel_pred"])


def test_random_init_matches_jax_init_rules():
    model = FastSpeech2.random_init(ModelConfig(vocab_size=9, **SMALL, **ADV), seed=1)
    assert torch.count_nonzero(model.advanced.vad_proj.weight) == 0
    assert 0 < model.advanced.speaker_embedding.weight.abs().max() < 0.1
    assert FastSpeech2(ModelConfig(vocab_size=9, **SMALL)).advanced is None


@pytest.mark.parametrize("age", [10.0, 25.0, 60.0, 80.5])
def test_age_and_lung_rules(age):
    assert adv.age_pitch_scale(age, 1.1) == jax_adv.age_pitch_scale(age, 1.1)
    lc = age / 100.0
    assert dataclasses.astuple(adv.lung_capacity_effect(lc)) == \
        dataclasses.astuple(jax_adv.lung_capacity_effect(lc))


def test_emphasis_and_words():
    for spec in ("1.0,1.5,1.0", " 2, ,0.5 ", ""):
        assert emphasis.parse_emphasis(spec) == jax_emph.parse_emphasis(spec)
    with pytest.raises(UserError, match="word_emphasis"):
        emphasis.parse_emphasis("1,x")
    g, jg = G2P("rules"), JaxG2P("rules")
    for text in (TEXT, "don't stop-me at 42, ok?", "state-of-the-art 3.5"):
        per_word = g.phonemes_per_word(text)
        assert per_word == jg.phonemes_per_word(text)
        for scales in ([1.0, 1.5], [2.0] * 12):
            np.testing.assert_array_equal(emphasis.word_emphasis_to_phonemes(scales, per_word),
                                          jax_emph.word_emphasis_to_phonemes(scales, per_word))


def test_prosody_tables_and_vad_knobs():
    assert prosody.ProsodyPolicy().styles == jax_prosody.ProsodyPolicy().styles
    for style in ("neutral", "exhausted", "relief", "anxious", "angry", "unknown"):
        a = prosody.ProsodyManager().get_curves(style, 17)
        b = jax_prosody.ProsodyManager().get_curves(style, 17)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for v in np.linspace(-1.2, 1.2, 5):
        for a_ in np.linspace(-1, 1, 3):
            for d in (-1.0, 0.0, 0.7):
                assert prosody.vad_to_knobs(v, a_, d) == jax_prosody.vad_to_knobs(v, a_, d)


@pytest.mark.parametrize("counts,lc,ds", [([10, 10, 10], 1.0, 1.0), ([10, 10, 10], 0.3, 1.0),
                                           ([14, 12, 16, 10, 15], 0.2, 1.0),
                                           ([14, 12, 16, 10, 15], 0.6, 1.6),
                                           ([20, 20], 0.8, 1.0), ([40, 20], 0.4, 1.0), ([7], 0.1, 1.0)])
def test_plan_breaths_matches_jax(counts, lc, ds):
    ours = breath.plan_breaths(counts, lc, duration_scale=ds)
    ref = jax_breath.plan_breaths(counts, lc, duration_scale=ds)
    assert [e and dataclasses.astuple(e) for e in ours] == [e and dataclasses.astuple(e) for e in ref]
    for text in (TEXT, "one, two. three!", "a — b; c", ""):
        assert breath.split_phrases(text) == jax_breath.split_phrases(text)


# -- DSP ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 63, 65, 1000, 8821])
def test_filters_match_jax_and_scipy(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    xt = torch.as_tensor(x)
    sos = filters.butter_sos(2, [1500, 6000], btype="bandpass", fs=22050)
    b, a = filters.butter_ba(1, 0.2)
    cases = [
        (filters.sosfilt(sos, xt), jax_filters.sosfilt(sos, jnp.asarray(x)),
         scipy.signal.sosfilt(sos.astype(np.float64), x)),
        (filters.lfilter(b, a, xt), jax_filters.lfilter(b, a, jnp.asarray(x)),
         scipy.signal.lfilter(b, a, x.astype(np.float64))),
        (filters.biquad_plain(xt, sos[0, :3], sos[0, 3:]),
         jax_filters.biquad(jnp.asarray(x), jnp.asarray(sos[0, :3]), jnp.asarray(sos[0, 3:])),
         scipy.signal.sosfilt(sos[:1].astype(np.float64), x)),
        (filters.biquad(xt, sos[1, :3], sos[1, 3:]), jax_filters.biquad(
            jnp.asarray(x), jnp.asarray(sos[1, :3]), jnp.asarray(sos[1, 3:])),
         filters.biquad_plain(xt, sos[1, :3], sos[1, 3:]).numpy()),
    ]
    for ours, jref, sref in cases:
        ours = ours.numpy()
        scale = max(np.abs(sref).max(), 1e-12)
        assert ours.shape == (n,) and ours.dtype == np.float32
        assert np.abs(ours - np.asarray(jref)).max() <= 1e-5 * scale
        assert np.abs(ours - sref).max() <= 1e-5 * scale
    # lfilter of a first-order filter equals the biquad oracle with b2 = a2 = 0
    np.testing.assert_allclose(filters.lfilter(b, a, xt).numpy(),
                               filters.biquad_plain(xt, [*b, 0.0], [*a, 0.0]).numpy(),
                               atol=1e-5 * max(np.abs(cases[1][2]).max(), 1e-12))


def test_mel_dsp_matches_jax(jax_noise):
    mel = torch.as_tensor(np.random.default_rng(0).uniform(-9, 1.9, (1, 57, NMEL)).astype(np.float32))
    jm = jnp.asarray(mel.numpy())
    for kw in (dict(breathiness=0.3), dict(roughness=0.2), dict(nasality=0.4),
               dict(breathiness=0.3, roughness=0.2, nasality=0.4), {}):
        ours = mel_dsp.apply_voice_quality(mel, 5, **kw).numpy()
        ref = np.asarray(jax_dsp.apply_voice_quality(jm, jax.random.PRNGKey(5), **kw))
        assert np.abs(ours - ref).max() < 1e-6
    assert torch.equal(mel_dsp.apply_voice_quality(mel, 0), mel.clamp(-10, 2))


def test_dsp_noise_is_seeded_on_the_cpu():
    a = mel_dsp.dsp_noise((2, 3), 7, "cpu")
    assert torch.equal(a, mel_dsp.dsp_noise((2, 3), 7, torch.device("cpu")))
    assert not torch.equal(a, mel_dsp.dsp_noise((2, 3), 8, "cpu"))


def test_vocal_events_match_jax(jax_noise):
    ours, ref = VocalEventSynth(sr=22050, seed=0, device="cpu"), JaxEvents(sr=22050, seed=0)
    for name in ("sigh", "breath_in", "grunt", "simple-sigh", "unknown"):
        if name == "simple-sigh":
            a, b = ours.generate_simple("sigh"), ref.generate_simple("sigh")
        elif name == "breath_in":
            a, b = ours.generate_breath_in(0.41, 0.7), ref.generate_breath_in(0.41, 0.7)
        else:
            a, b = ours.get_event(name), ref.get_event(name)
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-6)


def test_vocal_events_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VocalEventSynth()


# -- end to end ----------------------------------------------------------------


def _pair(spev_path, hifigan=None):
    js = JaxSynth(spev_path, hifigan_dir=None, **BUCKETS)
    ts = Synthesizer(spev_path, hifigan_dir=None, device="cpu", **BUCKETS)
    if hifigan is not None:
        js.vocoder, ts.vocoder = hifigan
    return js, ts


def test_advanced_controls_match_jax_hifigan(spev_path, hifigan, jax_noise):
    js, ts = _pair(spev_path, hifigan)
    assert ts.has_advanced and ts.model_cfg.use_nasality and ts.model_cfg.n_speakers == 4
    kw = dict(CONTROLS, lung_capacity=0.2)
    jw, jm = jax_controls(js, TEXT, **kw)
    tw, tm = synthesize_advanced_controls(ts, TEXT, **kw)
    assert tm.shape == jm.shape and tw.shape == jw.shape
    assert np.abs(tm - jm).mean() < 1e-4
    assert np.abs(tw - jw).mean() < 1e-5
    # the breath path: the waveform is the mel's hop span plus each planned
    # inhale and its two 60 ms pauses
    phrases = breath.split_phrases(TEXT)
    dur = prosody.vad_to_knobs(-0.5, 0.6, -0.3)["duration_scale"] * \
        adv.lung_capacity_effect(0.2).duration_scale
    plan = breath.plan_breaths([len(ts.g2p.phonemes(p)) for p in phrases], 0.2, duration_scale=dur)
    assert len(phrases) == 3 and any(plan)
    extra = sum(int(22050 * e.duration) + 2 * int(0.06 * 22050) for e in plan if e is not None)
    assert tw.shape[0] == tm.shape[0] * 256 + extra
    assert np.isfinite(tw).all() and np.isfinite(tm).all()


def test_advanced_controls_match_jax_griffin_lim(spev_path, jax_noise):
    js, ts = _pair(spev_path)
    assert not ts.vocoder.is_neural
    jw, jm = jax_controls(js, "second phrase follows", **CONTROLS)
    tw, tm = synthesize_advanced_controls(ts, "second phrase follows", **CONTROLS)
    assert tm.shape == jm.shape and tw.shape == jw.shape == (tm.shape[0] * 256,)
    assert np.abs(tm - jm).mean() < 1e-4


def test_conditioning_moves_the_output(spev_path, hifigan):
    _, ts = _pair(spev_path, hifigan)
    text = "second phrase follows"
    base = synthesize_advanced_controls(ts, text, speaker=0)[1]
    assert not np.array_equal(base, synthesize_advanced_controls(ts, text, speaker=2)[1])
    vad = synthesize_advanced_controls(ts, text, speaker=0, valence=-0.5, arousal=0.6,
                                       dominance=-0.3)[1]
    assert not np.array_equal(base, vad)
    flat = synthesize_advanced_controls(ts, text, word_emphasis="1,1,1")[1]
    emph = synthesize_advanced_controls(ts, text, word_emphasis="1,1.5,2")[1]
    assert emph.shape[0] > flat.shape[0]


def test_cli_in_process(spev_path, tmp_path, capsys):
    out = str(tmp_path / "a.wav")
    argv = ["--checkpoint", spev_path, "--hifigan_dir", str(tmp_path / "none"), "--text",
            "second phrase follows", "--breathiness", "0.3", "--speaker", "2", "--valence",
            "-0.5", "--word_emphasis", "1,2", "--device", "cpu", "--output", out]
    assert cli_main(argv) == 0
    assert "wrote" in capsys.readouterr().out
    from spev_tpu_torch.utils.wavio import read_wav

    wav, sr = read_wav(out)
    assert sr == 22050 and len(wav) > 0 and len(wav) % 256 == 0
    for bad in (["--checkpoint", str(tmp_path / "missing.spev")],
                ["--checkpoint", spev_path, "--word_emphasis", "1,x"],
                ["--checkpoint", spev_path, "--speaker", "4"]):
        assert cli_main(bad + ["--device", "cpu", "--hifigan_dir", str(tmp_path / "none"),
                               "--output", out]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error:") and err.count("\n") == 1
