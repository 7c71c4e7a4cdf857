"""English Porter2 (Snowball) stemmer: a frozen copy of the port's
`text/stemmer_en.py`, so that the reference's BM25 analyses text
without importing the program. Kept as it was copied; the port's
own may change, this one may not.


Behavioral parity with the reference's implementation
(pkg/textanalyzer/stemmer_english.go:106-325); written directly from the
public Porter2 algorithm specification (snowballstem.org/algorithms/english).
Pure string code — host-side by design (SURVEY §7.3 M4).
"""

from __future__ import annotations

_VOWELS = set("aeiouy")
_DOUBLES = {"bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt"}
_LI_ENDING = set("cdeghkmnrt")

_EXCEPTIONS = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl", "sky": "sky",
    "news": "news", "howe": "howe", "atlas": "atlas", "cosmos": "cosmos",
    "bias": "bias", "andes": "andes",
}
_EXCEPTIONS_1A = {"inning", "outing", "canning", "herring", "earring",
                  "proceed", "exceed", "succeed"}


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _regions(word: str) -> tuple[int, int]:
    """R1/R2 start offsets per the Porter2 definition."""
    n = len(word)
    r1 = n
    if word.startswith(("gener", "commun", "arsen")):
        r1 = 5 if word.startswith("gener") or word.startswith("arsen") else 6
    else:
        for i in range(1, n):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = n
    for i in range(r1 + 1, n):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _short_syllable_at_end(word: str) -> bool:
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        c, v, c2 = word[-3], word[-2], word[-1]
        return (c not in _VOWELS and v in _VOWELS
                and c2 not in _VOWELS and c2 not in "wxy")
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _short_syllable_at_end(word)


def stem_english(word: str) -> str:
    word = word.lower()
    if len(word) <= 2:
        return word
    if word in _EXCEPTIONS:
        return _EXCEPTIONS[word]

    word = word.lstrip("'")
    if word.startswith("y"):
        word = "Y" + word[1:]
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1, r2 = _regions(word)

    # step 0: strip apostrophe suffixes
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-2] if len(word[:-3]) > 1 else word[:-1]
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if any(ch in _VOWELS for ch in word[:-2]):
            word = word[:-1]

    if word in _EXCEPTIONS_1A:
        return word.lower().replace("Y", "y")

    # step 1b
    for suf in ("eedly", "eed"):
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + "ee"
            break
    else:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                stem = word[: -len(suf)]
                if any(ch in _VOWELS for ch in stem):
                    word = stem
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word[-2:] in _DOUBLES:
                        word = word[:-1]
                    elif _is_short(word, r1):
                        word += "e"
                break

    # step 1c
    if (len(word) > 2 and word[-1] in "yY"
            and word[-2] not in _VOWELS):
        word = word[:-1] + "i"

    # step 2
    step2 = [
        ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
        ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
        ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
        ("ation", "ate"), ("alism", "al"), ("aliti", "al"),
        ("ousli", "ous"), ("iviti", "ive"), ("fulli", "ful"),
        ("enci", "ence"), ("anci", "ance"), ("abli", "able"),
        ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
        ("bli", "ble"), ("ogi", "og"), ("li", ""),
    ]
    for suf, rep in step2:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ogi":
                    if word.endswith("logi"):
                        word = word[:-1]
                elif suf == "li":
                    if len(word) >= 3 and word[-3] in _LI_ENDING:
                        word = word[:-2]
                else:
                    word = word[: -len(suf)] + rep
            break

    # step 3
    step3 = [("ational", "ate"), ("tional", "tion"), ("alize", "al"),
             ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
             ("ful", ""), ("ness", ""), ("ative", "")]
    for suf, rep in step3:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ative":
                    if len(word) - len(suf) >= r2:
                        word = word[: -len(suf)]
                else:
                    word = word[: -len(suf)] + rep
            break

    # step 4
    step4 = ["ement", "ance", "ence", "able", "ible", "ment",
             "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
             "ion", "al", "er", "ic"]
    for suf in step4:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                if suf == "ion":
                    if len(word) >= 4 and word[-4] in "st":
                        word = word[:-3]
                else:
                    word = word[: -len(suf)]
            break

    # step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2 or (
                len(word) - 1 >= r1
                and not _short_syllable_at_end(word[:-1])):
            word = word[:-1]
    elif word.endswith("ll") and len(word) - 1 >= r2:
        word = word[:-1]

    return word.replace("Y", "y")
