"""A frozen copy of the rules G2P (English text -> espeak-style IPA characters)
and its lexicon, so the reference turns text into phoneme ids without the
program under test.

`phonemes` gives ``['<SIL>'] + list(ipa) + ['<SIL>']``; `PHONEME_SET` is
every mark it can emit, and `vocab` the symbol list built from it the way
the program builds one (sorted, with the three specials).
"""

from __future__ import annotations

import re

SPECIALS = ("<PAD>", "<UNK>", "<SIL>")

LEXICON = {
    # articles / conjunctions / prepositions
    "the": "ðə", "a": "ɐ", "an": "ɐn", "and": "ænd", "or": "ɔːɹ",
    "but": "bʌt", "of": "ʌv", "to": "tuː", "in": "ɪn", "on": "ɑːn",
    "at": "æt", "by": "baɪ", "for": "fɔːɹ", "with": "wɪð", "from": "fɹʌm",
    "as": "æz", "into": "ɪntuː", "about": "ɐbaʊt", "over": "oʊvɚ",
    "under": "ʌndɚ", "between": "bɪtwiːn", "through": "θɹuː",
    "after": "æftɚ", "before": "bɪfɔːɹ", "against": "ɐgɛnst",
    # pronouns / determiners
    "i": "aɪ", "you": "juː", "he": "hiː", "she": "ʃiː", "it": "ɪt",
    "we": "wiː", "they": "ðeɪ", "me": "miː", "him": "hɪm", "her": "hɜː",
    "us": "ʌs", "them": "ðɛm", "my": "maɪ", "your": "jʊɹ", "his": "hɪz",
    "its": "ɪts", "our": "aʊɚ", "their": "ðɛɹ", "this": "ðɪs",
    "that": "ðæt", "these": "ðiːz", "those": "ðoʊz", "who": "huː",
    "what": "wʌt", "which": "wɪtʃ", "where": "wɛɹ", "when": "wɛn",
    "why": "waɪ", "how": "haʊ", "all": "ɔːl", "any": "ɛni", "some": "sʌm",
    "no": "noʊ", "every": "ɛvɹi", "each": "iːtʃ", "both": "boʊθ",
    "few": "fjuː", "many": "mɛni", "most": "moʊst", "other": "ʌðɚ",
    "such": "sʌtʃ", "one": "wʌn", "two": "tuː", "three": "θɹiː",
    "four": "fɔːɹ", "five": "faɪv", "six": "sɪks", "seven": "sɛvən",
    "eight": "eɪt", "nine": "naɪn", "ten": "tɛn", "zero": "zɪɹoʊ",
    # verbs
    "is": "ɪz", "am": "æm", "are": "ɑːɹ", "was": "wʌz", "were": "wɜː",
    "be": "biː", "been": "bɪn", "being": "biːɪŋ", "have": "hæv",
    "has": "hæz", "had": "hæd", "do": "duː", "does": "dʌz", "did": "dɪd",
    "done": "dʌn", "will": "wɪl", "would": "wʊd", "can": "kæn",
    "could": "kʊd", "shall": "ʃæl", "should": "ʃʊd", "may": "meɪ",
    "might": "maɪt", "must": "mʌst", "go": "goʊ", "goes": "goʊz",
    "went": "wɛnt", "gone": "gɔːn", "come": "kʌm", "came": "keɪm",
    "get": "gɛt", "got": "gɑːt", "make": "meɪk", "made": "meɪd",
    "know": "noʊ", "knew": "nuː", "known": "noʊn", "think": "θɪŋk",
    "thought": "θɔːt", "take": "teɪk", "took": "tʊk", "see": "siː",
    "saw": "sɔː", "seen": "siːn", "say": "seɪ", "says": "sɛz",
    "said": "sɛd", "give": "gɪv", "gave": "geɪv", "find": "faɪnd",
    "found": "faʊnd", "tell": "tɛl", "told": "toʊld", "ask": "æsk",
    "work": "wɜːk", "seem": "siːm", "feel": "fiːl", "felt": "fɛlt",
    "leave": "liːv", "left": "lɛft", "put": "pʊt", "mean": "miːn",
    "keep": "kiːp", "let": "lɛt", "begin": "bɪgɪn", "began": "bɪgæn",
    "show": "ʃoʊ", "hear": "hɪɹ", "heard": "hɜːd", "play": "pleɪ",
    "run": "ɹʌn", "move": "muːv", "live": "lɪv", "believe": "bɪliːv",
    "bring": "bɹɪŋ", "brought": "bɹɔːt", "happen": "hæpən",
    "write": "ɹaɪt", "wrote": "ɹoʊt", "sit": "sɪt", "stand": "stænd",
    "lose": "luːz", "lost": "lɔːst", "pay": "peɪ", "paid": "peɪd",
    "meet": "miːt", "met": "mɛt", "include": "ɪnkluːd", "set": "sɛt",
    "learn": "lɜːn", "change": "tʃeɪndʒ", "lead": "liːd", "watch": "wɑːtʃ",
    "follow": "fɑːloʊ", "stop": "stɑːp", "create": "kɹiːeɪt",
    "speak": "spiːk", "spoke": "spoʊk", "read": "ɹiːd", "listen": "lɪsən",
    "love": "lʌv", "like": "laɪk", "want": "wɑːnt", "need": "niːd",
    "use": "juːz", "try": "tɹaɪ", "call": "kɔːl", "look": "lʊk",
    # adverbs / misc
    "not": "nɑːt", "now": "naʊ", "then": "ðɛn", "here": "hɪɹ",
    "there": "ðɛɹ", "very": "vɛɹi", "just": "dʒʌst", "only": "oʊnli",
    "also": "ɔːlsoʊ", "well": "wɛl", "even": "iːvən", "back": "bæk",
    "still": "stɪl", "too": "tuː", "more": "mɔːɹ", "less": "lɛs",
    "again": "ɐgɛn", "once": "wʌns", "never": "nɛvɚ", "always": "ɔːlweɪz",
    "often": "ɔːfən", "today": "tədeɪ",
    "yes": "jɛs", "if": "ɪf", "so": "soʊ", "because": "bɪkʌz",
    "while": "waɪl", "though": "ðoʊ", "although": "ɔːlðoʊ",
    "really": "ɹɪli", "right": "ɹaɪt", "down": "daʊn", "out": "aʊt",
    "up": "ʌp", "off": "ɔːf", "away": "ɐweɪ", "together": "təgɛðɚ",
    # common nouns
    "time": "taɪm", "people": "piːpəl", "year": "jɪɹ", "day": "deɪ",
    "way": "weɪ", "man": "mæn", "woman": "wʊmən", "world": "wɜːld",
    "life": "laɪf", "hand": "hænd", "part": "pɑːɹt", "child": "tʃaɪld",
    "children": "tʃɪldɹən", "eye": "aɪ", "place": "pleɪs",
    "house": "haʊs", "water": "wɔːtɚ", "word": "wɜːd", "thing": "θɪŋ",
    "night": "naɪt", "friend": "fɹɛnd", "mother": "mʌðɚ",
    "father": "fɑːðɚ", "voice": "vɔɪs", "speech": "spiːtʃ",
    "sound": "saʊnd", "music": "mjuːzɪk", "language": "læŋgwɪdʒ",
    "system": "sɪstəm", "machine": "məʃiːn", "question": "kwɛstʃən",
    "answer": "ænsɚ", "idea": "aɪdiːə", "heart": "hɑːɹt",
    "money": "mʌni", "business": "bɪznəs", "school": "skuːl",
    "hello": "həloʊ", "hi": "haɪ", "good": "gʊd", "great": "gɹeɪt",
    "new": "nuː", "old": "oʊld", "little": "lɪtəl", "own": "oʊn",
    "long": "lɔːŋ", "high": "haɪ", "small": "smɔːl", "large": "lɑːɹdʒ",
    "different": "dɪfɹənt", "important": "ɪmpɔːɹtənt", "sure": "ʃʊɹ",
    "beautiful": "bjuːtɪfəl",
}

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


def phonemes(text: str) -> list:
    """``['<SIL>'] + ipa characters + ['<SIL>']``."""
    return ["<SIL>"] + list(rules_phonemize(text)) + ["<SIL>"]


def _emittable() -> set:
    marks = {" ", "z"}
    for ipa in list(LEXICON.values()) + [r for _, r in _DIGRAPHS] + list(_LETTERS.values()):
        marks.update(ipa)
    return marks


PHONEME_SET = frozenset(_emittable())


def vocab() -> list:
    """Sorted symbols: every emittable mark and the three specials."""
    return sorted(PHONEME_SET | set(SPECIALS))


def encode(marks, symbols) -> list:
    """Marks -> ids, unknown marks as 1 (the inference convention)."""
    index = {s: i for i, s in enumerate(symbols)}
    return [index.get(m, 1) for m in marks]
