"""Grapheme-to-phoneme frontends (own copy of ``spev_tpu.text.g2p``).

Three backends:

1. ``espeak`` — ``['<SIL>'] + list(phonemize(text, language='en-us',
   backend='espeak', strip=True)) + ['<SIL>']``; the IPA *string* is split
   into single characters, so vocab entries are individual IPA chars.  Used
   when the ``phonemizer`` package (and espeak-ng) is importable.
2. ``cmudict`` — CMU Pronouncing Dictionary → ARPABET tokens with stress
   digits; OOV words map to ``<SIL>``.  Used when a cmudict file is found.
3. ``rules`` — a built-in deterministic English frontend: a ~200-entry
   high-frequency lexicon (`spev_tpu_torch.text.lexicon`) backed by
   letter-to-sound digraph rules, emitting espeak-style IPA characters.  It
   needs nothing external, so it always works offline.

``backend='auto'`` picks the best available in the order above.
"""

from __future__ import annotations

import os
import re
import threading
from typing import List, Optional

from spev_tpu_torch.text.vocab import SIL

try:  # optional dependency
    from phonemizer import phonemize as _phonemize_unlocked  # type: ignore

    _HAS_ESPEAK = True
except Exception:  # pragma: no cover
    _phonemize_unlocked = None
    _HAS_ESPEAK = False

# a word for per-word phoneme lists (word emphasis); the advanced API counts
# a phrase's words with the same pattern
WORD_RE = re.compile(r"[a-zA-Z']+|\d+")

# libespeak-ng keeps global state and is not thread-safe: concurrent requests
# serialize through this lock, held only around the C call.
_ESPEAK_LOCK = threading.Lock()


def _espeak_phonemize(*args, **kwargs):
    with _ESPEAK_LOCK:
        return _phonemize_unlocked(*args, **kwargs)


# ---------------------------------------------------------------------------
# rule-based fallback G2P (graphemes -> IPA-style chars)
# ---------------------------------------------------------------------------

# ordered digraph/trigraph rules; first match wins
_DIGRAPHS = [
    ("tch", "tʃ"),
    ("sch", "sk"),
    ("igh", "aɪ"),
    ("eigh", "eɪ"),
    ("ough", "ʌf"),
    ("tion", "ʃən"),
    ("sion", "ʒən"),
    ("ng", "ŋ"),
    ("ch", "tʃ"),
    ("sh", "ʃ"),
    ("th", "θ"),
    ("ph", "f"),
    ("wh", "w"),
    ("qu", "kw"),
    ("ck", "k"),
    ("gh", "g"),
    ("kn", "n"),
    ("wr", "r"),
    ("ee", "iː"),
    ("ea", "iː"),
    ("oo", "uː"),
    ("ou", "aʊ"),
    ("ow", "aʊ"),
    ("oi", "ɔɪ"),
    ("oy", "ɔɪ"),
    ("ay", "eɪ"),
    ("ai", "eɪ"),
    ("au", "ɔː"),
    ("aw", "ɔː"),
    ("ar", "ɑːɹ"),
    ("or", "ɔːɹ"),
    ("er", "ɚ"),
    ("ir", "ɜː"),
    ("ur", "ɜː"),
]

_LETTERS = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "g",
    "h": "h", "i": "ɪ", "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n",
    "o": "ɑː", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
    "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z",
}

_NUM_WORDS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}


def _rules_word_to_ipa(word: str) -> str:
    w = word.lower()
    from spev_tpu_torch.text.lexicon import LEXICON

    if w in LEXICON:
        return LEXICON[w]
    if w.endswith("'s") and w[:-2] in LEXICON:
        return LEXICON[w[:-2]] + "z"
    if w.endswith("s") and w[:-1] in LEXICON:
        return LEXICON[w[:-1]] + "z"
    out = []
    i = 0
    while i < len(w):
        matched = False
        for pat, rep in _DIGRAPHS:
            if w.startswith(pat, i):
                out.append(rep)
                i += len(pat)
                matched = True
                break
        if matched:
            continue
        ch = w[i]
        # silent final e
        if ch == "e" and i == len(w) - 1 and len(w) > 2:
            i += 1
            continue
        out.append(_LETTERS.get(ch, ""))
        i += 1
    return "".join(out)


def rules_phonemize(text: str) -> str:
    """Deterministic rule G2P → IPA char string (espeak-shaped output)."""
    text = re.sub(r"\d", lambda m: " " + _NUM_WORDS[m.group(0)] + " ", text)
    words = re.findall(r"[a-zA-Z']+", text)
    return " ".join(_rules_word_to_ipa(w) for w in words)


# ---------------------------------------------------------------------------
# cmudict backend
# ---------------------------------------------------------------------------


class CMUDict:
    """CMU Pronouncing Dictionary (ARPABET with stress digits).

    Accepts the standard ``cmudict.dict`` / ``cmudict-0.7b`` formats.
    OOV handling matches the documented reference behavior: the word maps to
    a single ``<SIL>`` token (``PRODUCTION_SYSTEM_SUMMARY.md:18-22``).
    """

    def __init__(self, path: str):
        self.entries = {}
        enc = "latin-1" if path.endswith("0.7b") else "utf-8"
        with open(path, encoding=enc, errors="ignore") as f:
            for line in f:
                if not line.strip() or line.startswith(";;;"):
                    continue
                parts = line.split()
                word = parts[0].lower()
                word = re.sub(r"\(\d+\)$", "", word)  # alternate pron markers
                if word not in self.entries:
                    self.entries[word] = parts[1:]

    def word_to_arpabet(self, word: str) -> List[str]:
        w = word.lower().strip("'")
        if w in self.entries:
            return list(self.entries[w])
        return [SIL]

    def text_to_phonemes(self, text: str) -> List[str]:
        text = re.sub(r"\d", lambda m: " " + _NUM_WORDS[m.group(0)] + " ", text)
        words = re.findall(r"[a-zA-Z']+", text)
        out: List[str] = []
        for w in words:
            out.extend(self.word_to_arpabet(w))
        return out


_CMUDICT_SEARCH_PATHS = (
    "data/cmudict.dict",
    "data/cmudict-0.7b",
)


def _find_cmudict() -> Optional[str]:
    for p in _CMUDICT_SEARCH_PATHS:
        if os.path.exists(p):
            return p
    return os.environ.get("SPEV_CMUDICT") if os.path.exists(os.environ.get("SPEV_CMUDICT", "")) else None


# ---------------------------------------------------------------------------
# unified frontend
# ---------------------------------------------------------------------------


class G2P:
    """Unified G2P frontend producing reference-shaped token lists."""

    def __init__(self, backend: str = "auto", cmudict_path: Optional[str] = None):
        if backend == "auto":
            if _HAS_ESPEAK:
                backend = "espeak"
            elif cmudict_path or _find_cmudict():
                backend = "cmudict"
            else:
                backend = "rules"
        self.backend = backend
        self._cmu = None
        if backend == "cmudict":
            path = cmudict_path or _find_cmudict()
            if path is None:
                raise FileNotFoundError("cmudict backend requested but no dictionary found")
            self._cmu = CMUDict(path)

    def phonemes(self, text: str) -> List[str]:
        """Reference tokenization: ``['<SIL>'] + tokens + ['<SIL>']``.

        espeak/rules backends split the IPA string into single characters
        (``spev_real_metrics.py:753``); cmudict yields ARPABET tokens."""
        if self.backend == "espeak":
            ipa = _espeak_phonemize(text, language="en-us", backend="espeak", strip=True)
            return [SIL] + list(ipa) + [SIL]
        if self.backend == "cmudict":
            return [SIL] + self._cmu.text_to_phonemes(text) + [SIL]
        return [SIL] + list(rules_phonemize(text)) + [SIL]

    def phonemes_per_word(self, text: str) -> List[List[str]]:
        """Per-word phoneme lists (for word-level emphasis mapping)."""
        out = []
        for w in WORD_RE.findall(text):
            if self.backend == "espeak":
                out.append(list(_espeak_phonemize(w, language="en-us", backend="espeak", strip=True)))
            elif self.backend == "cmudict":
                out.append(self._cmu.text_to_phonemes(w))
            else:
                out.append(list(rules_phonemize(w)))
        return out


def phonemize_text(text: str, backend: str = "auto") -> List[str]:
    return G2P(backend).phonemes(text)
