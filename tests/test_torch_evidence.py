"""The port's learned-control evidence (`spev_tpu_torch.diag.evidence` and
the ``tools/torch_*_demo.py`` runners) against the JAX package's tools, run
unchanged on the CPU:

- ``median_f0`` and ``spectral_tilt`` against ``tools/advanced_controls_demo``'s
  on one seeded waveform and mel: F0 equal (pyin's decoded bins are equal,
  `tests/test_torch_features.py`), tilt within 1e-6;
- F3: the JAX tools' register and identity texts reach none of the formant
  corpus's phonemes through their G2P; the port reads them as phoneme names
  (`evidence.PhonemeReader`);
- on one tiny advanced ``.spev`` that JAX's `Trainer` writes (hidden 32,
  VAD, 3 speakers; a duration bias of log 3, a pitch bias and a nonzero VAD
  projection set before the save, as an untrained model predicts no
  frames): ``measure_registers`` against JAX's tool run unchanged, the
  port's given JAX's reading of the text, its rules G2P (predicted F0
  within 1e-4 relative, frames and corpus columns exact, the orderings
  equal), the identity synthesis against JAX's
  ``synthesize_advanced_controls(speaker=k)`` (mel within 1e-4 MAE, frames
  exact; both synthesizers read the text as phoneme names) and
  ``control_sweeps`` against
  ``advanced_controls_demo.main()`` (every frame, sample and breath count
  and rule multiplier exact, tilt within 1e-4; the age rows' audio F0 comes
  from Griffin-Lim, whose random phase cannot match JAX's bits, and is not
  compared);
- both training runners at toy scale (8 utterances, 1 epoch, hidden 32):
  the JSON's keys are the committed ``docs/demo`` file's, and every number
  is finite but where the JAX tools' own semantics give NaN (see
  `_numbers`).
"""

import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.config import SpevConfig as JaxSpevConfig
from spev_tpu.config import TrainConfig as JaxTrainConfig
from spev_tpu.infer.advanced_api import synthesize_advanced_controls as jax_controls
from spev_tpu.infer.synthesis import Synthesizer as JaxSynth
from spev_tpu.text.g2p import G2P as JaxG2P
from spev_tpu.text.lexicon import LEXICON
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.trainer import Trainer as JaxTrainer
from spev_tpu_torch.diag import evidence
from spev_tpu_torch.infer.advanced_api import synthesize_advanced_controls
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.text.g2p import G2P
from spev_tpu_torch.utils.params import read_checkpoint
from tools import advanced_controls_demo as jax_adv_demo
from tools import emotion_register_demo as jax_emo_demo

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS_PHONES = ("AA", "EH", "IY", "M", "OW", "S", "SH", "T", "UW")  # the formant corpus's
H = 32
SR = 22050


@pytest.fixture(autouse=True)
def _few_threads():
    # the six-worker run shares the machine's cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _voiced_signal(seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140.0 * 2 ** (0.3 * t)
    y = 0.5 * np.sin(2 * np.pi * np.cumsum(f0) / SR) + 0.02 * rng.standard_normal(t.size)
    return y.astype(np.float32)


def test_median_f0_and_spectral_tilt_match_jax():
    y = _voiced_signal()
    ours = evidence.median_f0(y, SR, device="cpu")
    ref = jax_adv_demo.median_f0(y, SR)
    assert math.isfinite(ours) and ours == ref
    mel = np.random.default_rng(1).normal(-4.0, 2.0, (57, 80)).astype(np.float32)
    assert abs(evidence.spectral_tilt(mel) - jax_adv_demo.spectral_tilt(mel)) < 1e-6


# -- one tiny advanced .spev written by JAX's Trainer -----------------------------


@pytest.fixture(scope="module")
def spev(tmp_path_factory):
    """JAX's Trainer at hidden 32 with VAD and 3 speakers, saved by
    ``trainer.save``; the port reads the same file."""
    work = tmp_path_factory.mktemp("evidence")
    # the G2P's IPA characters and the formant corpus's phoneme names
    vocab = JaxVocab.build(set("".join(LEXICON.values())) | {" "} | set(CORPUS_PHONES))
    cfg = JaxSpevConfig(
        model=JaxModelConfig(vocab_size=len(vocab), embed_dim=H, hidden_dim=H, n_mels=80,
                             n_encoder_layers=1, n_decoder_layers=1, max_phonemes=32,
                             max_frames=256, vp_output_norm=False, use_vad=True, n_speakers=3),
        train=JaxTrainConfig(batch_size=16))
    stats = {"p_mean": float(np.log(180.0)), "p_std": 0.25, "frames_per_phoneme": 2.0}
    trainer = JaxTrainer(cfg, vocab, stats, ckpt_dir=str(work / "ck"), log_dir=str(work / "logs"))
    params = jax.tree.map(np.asarray, trainer.state.params)
    rng = np.random.default_rng(0)
    dp = params["duration_predictor"]["proj"]
    dp["weight"] = (dp["weight"] * 0.05).astype(np.float32)
    dp["bias"] = np.asarray([np.log(3.0)], np.float32)  # ~2 frames a phoneme
    pp = params["pitch_predictor"]["proj"]
    pp["weight"] = (pp["weight"] * 0.2).astype(np.float32)
    pp["bias"] = np.asarray([0.3], np.float32)
    params["mel_linear"]["weight"] = params["mel_linear"]["weight"] * 30.0
    params["advanced"]["vad_proj"]["weight"] = rng.normal(0, 0.5, (H, 3)).astype(np.float32)
    params["advanced"]["speaker_embedding"]["weight"] = \
        rng.normal(0, 0.5, (3, H)).astype(np.float32)
    trainer.state = trainer.state._replace(params=jax.tree.map(jnp.asarray, params))
    return trainer.save("tiny", include_opt=False), work


def test_jax_tools_texts_miss_the_corpus_phonemes():
    """F3: the JAX tools' register and identity texts name formant-corpus
    phonemes, but their rules G2P spells them in IPA, none of which is in
    the corpus's vocabulary, so every id falls back to <SIL>; the port's
    `PhonemeReader` gives the named phonemes."""
    vocab = JaxVocab.build(CORPUS_PHONES)
    for text in (evidence.REGISTER_TEXT, evidence.IDENTITY_TEXT):
        ids = vocab.encode(JaxG2P("rules").phonemes(text), fallback=1)
        assert set(np.asarray(ids).tolist()) == {vocab.sil_id}
        named = evidence.PhonemeReader.phonemes(text)[1:-1]
        assert set(named) - set(CORPUS_PHONES) <= {"AH", "N"}


def test_measure_registers_matches_jax(spev, monkeypatch):
    path, work = spev
    ref = jax_emo_demo.measure_registers(path, str(work / "jax_emo.json"))
    # the port's measurement with JAX's reading of the text (F3)
    monkeypatch.setattr(evidence, "PhonemeReader", lambda: G2P("rules"))
    ours = evidence.measure_registers(path, str(work / "torch_emo.json"), device="cpu")
    assert json.load(open(work / "torch_emo.json")) == json.loads(json.dumps(ours))
    assert list(ours["registers"]) == list(ref["registers"])
    assert sorted(ours["registers"]) == sorted(evidence.EMOTIONS)
    for emo, r in ref["registers"].items():
        o = ours["registers"][emo]
        assert abs(o["pred_f0_hz"] - r["pred_f0_hz"]) <= 1e-4 * r["pred_f0_hz"], (emo, o, r)
        for key in ("vad", "synth_frames", "corpus_f0_mult", "corpus_dur_mult"):
            assert o[key] == r[key], (emo, key)
        assert o["synth_frames"] > 10
    # the VAD projection moves the predicted pitch apart
    assert len({r["pred_f0_hz"] for r in ours["registers"].values()}) == 4
    for key in ("f0_register_ordered", "duration_register_ordered"):
        assert ours[key] == ref[key]


def test_identity_synthesis_matches_jax(spev):
    path, _ = spev
    buckets = dict(g2p_backend="rules", phoneme_buckets=(32,), frame_buckets=(256,))
    js = JaxSynth(path, hifigan_dir=None, **buckets)
    ts = Synthesizer(path, hifigan_dir=None, device="cpu", **buckets)
    js.g2p = ts.g2p = evidence.PhonemeReader()
    mels = []
    for k in range(3):
        _, jm = jax_controls(js, evidence.IDENTITY_TEXT, speaker=k)
        _, tm = synthesize_advanced_controls(ts, evidence.IDENTITY_TEXT, speaker=k)
        assert tm.shape == jm.shape and tm.shape[0] > 10
        assert np.abs(tm - np.asarray(jm)).mean() < 1e-4
        mels.append(tm)
    assert not np.array_equal(mels[0], mels[2])


def test_control_sweeps_match_jax(spev, monkeypatch):
    path, work = spev
    monkeypatch.setenv("SPEV_COMPILATION_CACHE", "0")  # keep the tests' own cache setting
    monkeypatch.setattr(sys, "argv", ["advanced_controls_demo.py", "--checkpoint", path,
                                      "--out", str(work / "jax_sweeps")])
    jax_adv_demo.main()
    ref = json.load(open(work / "jax_sweeps" / "advanced_controls.json"))
    ours = evidence.control_sweeps(path, str(work / "torch_sweeps"), device="cpu")
    assert json.load(open(work / "torch_sweeps" / "advanced_controls.json")) == \
        json.loads(json.dumps(ours))
    assert set(ours) == set(ref)
    assert [(r["age"], r["formula_pitch_mult"]) for r in ours["age_sweep"]] == \
        [(r["age"], r["formula_pitch_mult"]) for r in ref["age_sweep"]]
    assert ours["emphasis"] == ref["emphasis"]
    assert ours["emphasis"]["emphasized_frames"] > ours["emphasis"]["baseline_frames"]
    for o, r in zip(ours["nasality_sweep"], ref["nasality_sweep"], strict=True):
        assert o["nasality"] == r["nasality"]
        assert abs(o["spectral_tilt"] - r["spectral_tilt"]) < 1e-4
    assert ours["nasality_monotone_darkening"] == ref["nasality_monotone_darkening"]
    assert ours["lung_sweep"] == ref["lung_sweep"]
    assert ours["lung_monotone"] == ref["lung_monotone"]
    assert [r["inserted_breaths"] for r in ours["lung_sweep"]][0] == 0
    assert ours["lung_sweep"][-1]["inserted_breaths"] >= 1
    # the model's pitch after the age rule: the scale the forward applies
    ts = Synthesizer(path, hifigan_dir=None, device="cpu", g2p_backend="rules",
                     **evidence.SWEEP_BUCKETS)
    f0 = evidence.age_model_f0(ts)
    assert all(math.isfinite(x) for x in f0) and len(set(f0)) == 4


# -- the training runners at toy scale ----------------------------------------------


def _numbers(obj, path=()):
    """(path, number) for every number in a JSON tree, leaving out the two
    places where the JAX tools themselves write NaN: the audio-level pyin F0
    of unvoiced Griffin-Lim audio (``synth_f0_hz``; the committed
    ``docs/demo/emotion_metrics.json`` holds NaN there) and the means of a
    held-out group with no utterance (n 0)."""
    if isinstance(obj, dict):
        if obj.get("n") == 0:
            return
        for k, v in obj.items():
            if k != "synth_f0_hz":
                yield from _numbers(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _numbers(v, path + (i,))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def _key_shape(obj, label_dicts=()):
    """The key tree of a JSON object; under the keys in ``label_dicts``
    (held-out groups whose labels depend on the split) only the rows' keys."""
    if not isinstance(obj, dict):
        return None
    out = {}
    for k, v in obj.items():
        if k in label_dicts:
            out[k] = sorted({tuple(sorted(r)) for r in v.values()})
        else:
            out[k] = _key_shape(v, label_dicts)
    return out


@pytest.mark.parametrize("tool, demo", [("torch_emotion_register_demo", "emotion_metrics"),
                                        ("torch_multispeaker_demo", "multispeaker_metrics")])
def test_training_runner_at_toy_scale(tool, demo, tmp_path):
    import importlib

    main = importlib.import_module(f"tools.{tool}").main
    out = tmp_path / f"{demo}.json"
    res = main(1, str(out), device="cpu", n_utterances=8, hidden=H, work=str(tmp_path / "w"))
    written = json.load(open(out))
    committed = json.load(open(ROOT / "docs" / "demo" / f"{demo}.json"))
    assert _key_shape(written, ("per_emotion_val",)) == \
        _key_shape(committed, ("per_emotion_val",))
    assert written == json.loads(json.dumps(res))
    numbers = list(_numbers(written))
    assert numbers and all(math.isfinite(v) for _, v in numbers), \
        [p for p, v in numbers if not math.isfinite(v)]
    assert written["epochs"] == 1
    if demo == "multispeaker_metrics":
        assert [r["corpus_f0_mult"] for r in written["identity"].values()] == [0.719, 1.0, 1.391]
    else:
        ckpt = read_checkpoint(str(tmp_path / "w" / "ck" / "emo_demo.spev"))
        w = np.asarray(ckpt["model"]["advanced.vad_proj.weight"])
        assert np.abs(w).max() > 0
        assert written["vad_proj_abs_mean"] > 0
