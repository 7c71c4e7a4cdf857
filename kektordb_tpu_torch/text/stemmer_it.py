"""Italian Snowball stemmer.

Behavioral parity with the reference (pkg/textanalyzer/stemmer_italian.go:
91-230); written from the public Snowball Italian specification
(snowballstem.org/algorithms/italian)."""

from __future__ import annotations

_VOWELS = set("aeiouàèìòù")

_ACCENT_FIX = str.maketrans({"á": "à", "é": "è", "í": "ì", "ó": "ò", "ú": "ù"})


def _regions(word: str) -> tuple[int, int, int]:
    """(rv, r1, r2) start offsets per the Snowball definitions."""
    n = len(word)
    # RV
    rv = n
    if n >= 2:
        if word[0] in _VOWELS and word[1] in _VOWELS:
            # vowel-vowel: rv after first following consonant
            for i in range(2, n):
                if word[i] not in _VOWELS:
                    rv = i + 1
                    break
        elif word[0] not in _VOWELS:
            for i in range(1, n):
                if word[i] in _VOWELS:
                    rv = i + 1
                    break
        else:  # vowel-consonant
            rv = 3 if n >= 3 else n
    r1 = n
    for i in range(1, n):
        if word[i] not in _VOWELS and word[i - 1] in _VOWELS:
            r1 = i + 1
            break
    r2 = n
    for i in range(r1 + 1, n):
        if word[i] not in _VOWELS and word[i - 1] in _VOWELS:
            r2 = i + 1
            break
    return rv, r1, r2


_STEP0 = ["gliela", "gliele", "glieli", "glielo", "gliene", "sene",
          "mela", "mele", "meli", "melo", "mene", "tela", "tele", "teli",
          "telo", "tene", "cela", "cele", "celi", "celo", "cene",
          "vela", "vele", "veli", "velo", "vene", "gli", "ci", "la",
          "le", "li", "lo", "mi", "ne", "si", "ti", "vi"]

_STEP1 = [
    ("atrice", ""), ("atrici", ""), ("azione", ""), ("azioni", ""),
    ("uzione", ""), ("uzioni", ""), ("usione", ""), ("usioni", ""),
    ("amento", ""), ("amenti", ""), ("imento", ""), ("imenti", ""),
    ("amente", "R1"), ("abile", ""), ("abili", ""), ("ibile", ""),
    ("ibili", ""), ("mente", ""), ("atore", ""), ("atori", ""),
    ("logia", "log"), ("logie", "log"),
    ("anza", ""), ("anze", ""), ("iche", ""), ("ichi", ""),
    ("ismo", ""), ("ismi", ""), ("ista", ""), ("iste", ""), ("isti", ""),
    ("istà", ""), ("istè", ""), ("istì", ""), ("ante", ""), ("anti", ""),
    ("enza", "ente"), ("enze", "ente"),
    ("ico", ""), ("ici", ""), ("ica", ""), ("ice", ""),
    ("oso", ""), ("osi", ""), ("osa", ""), ("ose", ""),
    ("ità", ""), ("ivo", ""), ("ivi", ""), ("iva", ""), ("ive", ""),
]

_STEP2 = [
    "erebbero", "irebbero", "assero", "assimo", "eranno", "erebbe",
    "eremmo", "ereste", "eresti", "essero", "iranno", "irebbe", "iremmo",
    "ireste", "iresti", "iscano", "iscono", "issero", "arono", "avamo",
    "avano", "avate", "eremo", "erete", "erono", "evamo", "evano", "evate",
    "iremo", "irete", "irono", "ivamo", "ivano", "ivate", "ammo", "ando",
    "asse", "assi", "emmo", "enda", "ende", "endi", "endo", "erai", "erei",
    "yamo", "iamo", "immo", "irai", "irei", "isca", "isce", "isci", "isco",
    "ano", "are", "ata", "ate", "ati", "ato", "ava", "avi", "avo", "erà",
    "ere", "erò", "ete", "eva", "evi", "evo", "irà", "ire", "irò", "ita",
    "ite", "iti", "ito", "iva", "ivi", "ivo", "ono", "uta", "ute", "uti",
    "uto", "ar", "ir",
]


def stem_italian(word: str) -> str:
    word = word.lower().translate(_ACCENT_FIX)
    if len(word) <= 2:
        return word
    # mark u/i between vowels as consonants (qu → qU etc.)
    chars = list(word)
    for i in range(1, len(chars) - 1):
        if chars[i] in "ui" and chars[i - 1] in _VOWELS and chars[i + 1] in _VOWELS:
            chars[i] = chars[i].upper()
        if chars[i] == "u" and chars[i - 1] == "q":
            chars[i] = "U"
    word = "".join(chars)
    rv, r1, r2 = _regions(word.lower())

    def in_rv(stem_len): return stem_len >= rv
    def in_r2(stem_len): return stem_len >= r2

    # step 0: attached pronouns after -ando/-endo or -ar/-er/-ir in RV
    for suf in _STEP0:
        if word.endswith(suf):
            base = len(word) - len(suf)
            prev = word[:base]
            if in_rv(base - 4) and prev.endswith(("ando", "endo")):
                word = prev
            elif in_rv(base - 2) and prev.endswith(("ar", "er", "ir")):
                word = prev + "e"
            break

    did_step1 = False
    for suf, rep in _STEP1:
        if word.endswith(suf):
            base = len(word) - len(suf)
            if rep == "R1":
                if base >= r1:
                    word = word[:base]
                    did_step1 = True
            elif rep == "log":
                if in_r2(base):
                    word = word[:base] + "log"
                    did_step1 = True
            elif suf in ("enza", "enze"):
                if in_r2(base):
                    word = word[:base] + "ente"
                    did_step1 = True
            elif in_r2(base):
                word = word[:base]
                did_step1 = True
                if suf in ("ità",) and word.endswith(("abil", "ic", "iv")):
                    for s2 in ("abil", "ic", "iv"):
                        if word.endswith(s2) and in_r2(len(word) - len(s2)):
                            word = word[: -len(s2)]
                            break
                elif suf in ("ivo", "ivi", "iva", "ive"):
                    if word.endswith("at") and in_r2(len(word) - 2):
                        word = word[:-2]
                        if word.endswith("ic") and in_r2(len(word) - 2):
                            word = word[:-2]
            break

    if not did_step1:
        for suf in _STEP2:
            if word.endswith(suf):
                base = len(word) - len(suf)
                if in_rv(base):
                    word = word[:base]
                break

    # step 3a: final vowel in RV (then final i after preceding removal)
    if word and word[-1] in "aeioàèìò" and in_rv(len(word) - 1):
        word = word[:-1]
        if word and word[-1] == "i" and in_rv(len(word) - 1):
            word = word[:-1]
    # step 3b: ch/gh → c/g
    if word.endswith(("ch", "gh")) and in_rv(len(word) - 1):
        word = word[:-1]

    return word.lower()
