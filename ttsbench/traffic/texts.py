"""Seeded English sentences whose audio lengths follow LJSpeech 1.1.

LJSpeech 1.1 holds 13,100 clips of 1.11-10.10 s, 6.57 s on average, most of
them long.  Audio lengths here come from a Beta(2.2, 1.4) law stretched over
[1.1, 10.1] s (mean 6.6 s, mode 7.9 s).  Every seed gets the same set of
lengths, the quantiles of that law, in its own order, so two seeds ask for
the same work: a text of ``s`` seconds gets ``round(s * phonemes_per_s)``
phonemes, made of words drawn from the frozen list beside this file.  The
seed picks the order and the words.  No text repeats within a generator.

Phonemes are counted with the reference's frozen rules G2P (``<SIL>``, the
words' IPA characters with a space between words, ``<SIL>``), so the count
needs no G2P call per text.
"""

from __future__ import annotations

import os

import numpy as np

from ttsbench.reference.g2p_rules import rules_phonemize

WORDS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "words.txt")


def beta_quantiles(n: int, a: float, b: float, lo: float, hi: float) -> np.ndarray:
    """The n mid-quantiles (k + 0.5) / n of Beta(a, b) on [lo, hi]."""
    x = np.linspace(0.0, 1.0, 20001)
    pdf = np.power(np.clip(x, 1e-12, 1.0), a - 1.0) * np.power(np.clip(1.0 - x, 1e-12, 1.0),
                                                                b - 1.0)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5 * np.diff(x))])
    cdf /= cdf[-1]
    q = (np.arange(n) + 0.5) / n
    return lo + (hi - lo) * np.interp(q, cdf, x)


class TextGenerator:
    """Unique sentences from ``seed``: ``texts(n)`` gives n sentences whose
    audio lengths are the n quantiles of the law, in an order of the seed."""

    def __init__(self, seed: int, phonemes_per_s: float, audio_s=(1.1, 10.1),
                 beta=(2.2, 1.4)):
        self.rng = np.random.default_rng(int(seed))
        self.phonemes_per_s = float(phonemes_per_s)
        self.audio_s = tuple(audio_s)
        self.beta = tuple(beta)
        with open(WORDS_FILE) as f:
            self.words = [w.strip() for w in f if w.strip()]
        self.cost = np.asarray([len(rules_phonemize(w)) for w in self.words])
        self.by_cost = {}
        for i, c in enumerate(self.cost):
            self.by_cost.setdefault(int(c), []).append(i)
        self.seen = set()

    def audio_lengths(self, n: int) -> np.ndarray:
        """The n quantile lengths in seconds, in this generator's order."""
        return self.rng.permutation(beta_quantiles(n, *self.beta, *self.audio_s))

    def phoneme_target(self, seconds: float) -> int:
        return max(4, int(round(seconds * self.phonemes_per_s)))

    def sentence(self, n_phonemes: int) -> str:
        """Random words whose G2P output has ``n_phonemes`` marks (one or two
        off where no word length closes the gap; a target too short to stay
        unique grows by one mark every 20 draws)."""
        tries = 0
        while True:
            tries += 1
            if tries % 20 == 0:
                n_phonemes += 1
            picked, have = [], 2  # the two <SIL>
            while True:
                room = n_phonemes - have - (1 if picked else 0)
                if room <= int(self.cost.max()):
                    break
                i = int(self.rng.integers(len(self.words)))
                have += int(self.cost[i]) + (1 if picked else 0)
                picked.append(i)
            room = n_phonemes - have - (1 if picked else 0)
            fits = [c for c in self.by_cost if c <= max(room, 1)]
            if fits:
                pool = self.by_cost[max(fits)]
                picked.append(pool[int(self.rng.integers(len(pool)))])
            text = " ".join(self.words[i] for i in picked)
            text = text[0].upper() + text[1:] + "."
            if text not in self.seen:
                self.seen.add(text)
                return text

    def texts(self, n: int) -> list:
        return [self.sentence(self.phoneme_target(s)) for s in self.audio_lengths(n)]

    def texts_of(self, seconds) -> list:
        """One sentence per given audio length, in the given order."""
        return [self.sentence(self.phoneme_target(s)) for s in seconds]
