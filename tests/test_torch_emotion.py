"""The port's emotion table (``spev_tpu_torch.data.emotion``) is the JAX
package's, row for row, alias for alias, and maps labels and file names
the same way."""

import numpy as np
import pytest

from spev_tpu.data import emotion as jax_emotion
from spev_tpu_torch.data import emotion

NAMES = sorted(jax_emotion.EMOTION_VAD) + sorted(jax_emotion._ALIASES) + [
    "Happy", "ANGER", " sad ", "stoic", "", "Surprised"]
BASENAMES = ["0011_000351_angry", "spk0_utt0007_happy.wav", "utt0007", "utt_0007",
             "a_b_JOY", "x_fearful.wav", "noext_", "spk_utt_neutral.flac"]


def test_table_and_aliases_equal_jax():
    assert emotion.EMOTION_VAD == jax_emotion.EMOTION_VAD
    assert list(emotion.EMOTION_VAD) == list(jax_emotion.EMOTION_VAD)
    assert emotion._ALIASES == jax_emotion._ALIASES


@pytest.mark.parametrize("name", NAMES)
def test_canonical_and_vad_equal_jax(name):
    assert emotion.canonical_emotion(name) == jax_emotion.canonical_emotion(name)
    if jax_emotion.canonical_emotion(name) is None:
        with pytest.raises(KeyError):
            emotion.vad_for_emotion(name)
    else:
        ours, ref = emotion.vad_for_emotion(name), jax_emotion.vad_for_emotion(name)
        assert ours.dtype == ref.dtype == np.float32 and np.array_equal(ours, ref)


@pytest.mark.parametrize("basename", BASENAMES)
def test_emotion_from_basename_equals_jax(basename):
    assert emotion.emotion_from_basename(basename) == jax_emotion.emotion_from_basename(basename)
