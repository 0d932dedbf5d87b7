"""The text generator: the same seed gives the same texts, no text repeats,
and the lengths follow the stated law."""

import numpy as np

from ttsbench.reference.g2p_rules import phonemes
from ttsbench.traffic.texts import TextGenerator, beta_quantiles

PPS = 22050 / 256 / 6


def test_same_seed_same_texts_and_another_seed_other_texts():
    seed = 2 ** 31 + 12345
    a, b = TextGenerator(seed, PPS).texts(64), TextGenerator(seed, PPS).texts(64)
    assert a == b
    assert TextGenerator(seed + 1, PPS).texts(64) != a


def test_no_text_repeats_within_a_generator():
    gen = TextGenerator(7, PPS)
    texts = gen.texts(300) + gen.texts(300)
    assert len(set(texts)) == len(texts)


def test_lengths_follow_the_ljspeech_law():
    q = beta_quantiles(1000, 2.2, 1.4, 1.1, 10.1)
    assert 1.1 < q.min() < 1.8 and 9.9 < q.max() < 10.1
    assert abs(q.mean() - 6.6) < 0.05
    gen = TextGenerator(11, PPS)
    seconds = gen.audio_lengths(128)
    np.testing.assert_allclose(np.sort(seconds), np.sort(beta_quantiles(128, 2.2, 1.4, 1.1, 10.1)))
    counts = np.array([len(phonemes(t)) for t in gen.texts_of(seconds)])
    targets = np.array([gen.phoneme_target(s) for s in seconds])
    assert np.all(np.abs(counts - targets) <= 2)
    audio = counts * 6 * 256 / 22050
    assert abs(audio.mean() - 6.6) < 0.15 and audio.min() >= 1.1 and audio.max() <= 10.4


def test_every_seed_gets_the_same_lengths_in_its_own_order():
    a, b = TextGenerator(1, PPS).audio_lengths(50), TextGenerator(2, PPS).audio_lengths(50)
    np.testing.assert_allclose(np.sort(a), np.sort(b))
    assert not np.allclose(a, b)
