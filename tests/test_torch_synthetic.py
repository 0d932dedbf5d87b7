"""The port's formant corpus (``spev_tpu_torch.data.synthetic``) against the
JAX package's: from one seed both write the same wavs, TextGrids and
transcripts, compared byte for byte (the float → int16 rounding of the
wavs and the TextGrids' float formatting included); the emotion and speaker
registers exactly; an unknown emotion raises."""

import os

import numpy as np
import pytest

from spev_tpu.data import synthetic as jax_syn
from spev_tpu.data.emotion import EMOTION_VAD as JAX_EMOTION_VAD
from spev_tpu_torch.data import synthetic as syn
from spev_tpu_torch.data.emotion import EMOTION_VAD


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kw", [
    dict(n_utterances=5, seed=0),
    dict(n_utterances=4, seed=3, n_speakers=2, emotions=("happy", "sad")),
    dict(n_utterances=4, seed=1, textgrid_dir="tg", syllable_range=(2, 3),
         duration_jitter=0.2, sr=16000, hop_length=200),
], ids=["default", "speakers-emotions", "options"])
def test_corpus_matches_jax_byte_for_byte(tmp_path, kw):
    dirs = {}
    for name, fn in (("jax", jax_syn.generate_formant_corpus),
                     ("port", syn.generate_formant_corpus)):
        root = tmp_path / name
        args = dict(kw)
        if "textgrid_dir" in args:
            args["textgrid_dir"] = str(root / args["textgrid_dir"])
        tg = fn(str(root / "wavs"), **args)
        assert os.path.isdir(tg) and tg.startswith(str(root))
        dirs[name] = root
    files = _files(dirs["jax"])
    assert files == _files(dirs["port"])
    n = kw["n_utterances"]
    assert sum(f.endswith(".wav") for f in files) == n
    assert sum(f.endswith(".TextGrid") for f in files) == n
    assert sum(f.endswith(".txt") for f in files) == n
    for f in files:
        a = (dirs["jax"] / f).read_bytes()
        b = (dirs["port"] / f).read_bytes()
        assert a == b, f
    if "emotions" in kw:
        assert any(f.endswith("spk1_utt0001_sad.wav") for f in files)


def test_registers_match_jax():
    assert list(EMOTION_VAD) == list(JAX_EMOTION_VAD)
    for name, vad in EMOTION_VAD.items():
        assert syn.emotion_prosody(vad) == jax_syn.emotion_prosody(JAX_EMOTION_VAD[name])
    for n in (1, 2, 3, 7):
        for k in range(n):
            assert syn.speaker_voice(k, n) == jax_syn.speaker_voice(k, n)


def test_phone_pieces_match_jax():
    assert syn._INVENTORY == tuple(syn.Phone(**vars(p)) for p in jax_syn._INVENTORY)
    y = np.random.default_rng(0).standard_normal(512)
    np.testing.assert_array_equal(syn._resonator(y, 730, 90, 22050),
                                  jax_syn._resonator(y, 730, 90, 22050))
    for seed in range(3):
        a = syn._sample_phone_seq(np.random.RandomState(seed), 5)
        b = jax_syn._sample_phone_seq(np.random.RandomState(seed), 5)
        assert a == b


def test_unknown_emotion_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown emotions"):
        syn.generate_formant_corpus(str(tmp_path), n_utterances=1, emotions=("happy", "elated"))
