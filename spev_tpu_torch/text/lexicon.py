"""Built-in pronunciation lexicon for the rule-based G2P fallback.

The letter-to-sound rules in `spev_tpu_torch.text.g2p` are deterministic but
naive; English's highest-frequency words are mostly irregular.  This
lexicon (~200 common words, espeak-style IPA) is consulted before the
rules, which covers the bulk of running text by token frequency.  With the
``phonemizer``/espeak backend installed this module is unused.
"""

from __future__ import annotations

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
