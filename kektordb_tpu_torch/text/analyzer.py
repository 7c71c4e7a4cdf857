"""Tokenizer + stopword filter + language analysis pipeline.

Reference: pkg/textanalyzer/analyzer.go:21-110 (tokenize, stopword filter,
stemming dispatch by language)."""

from __future__ import annotations

import re

from .stemmer_en import stem_english
from .stemmer_it import stem_italian

_TOKEN_RE = re.compile(r"[a-z0-9àèìòùáéíóú]+")

STOPWORDS_EN = frozenset("""
a about above after again against all am an and any are as at be because been
before being below between both but by can did do does doing down during each
few for from further had has have having he her here hers herself him himself
his how i if in into is it its itself just me more most my myself no nor not
now of off on once only or other our ours ourselves out over own same she
should so some such than that the their theirs them themselves then there
these they this those through to too under until up very was we were what
when where which while who whom why will with you your yours yourself
yourselves
""".split())

STOPWORDS_IT = frozenset("""
a ad al allo ai agli alla alle anche ancora avere aveva che chi ci cio come
con cosa cui da dal dallo dai dagli dalla dalle degli dei del dello della
delle dentro di dove e ed essere fra gli ha hanno il in io la le lei lo loro
lui ma mi mia mie miei mio ne nei nel nello nella nelle noi non nostra nostre
nostri nostro o per perche piu quale quanta quante quanti quanto quella quelle
quelli quello questa queste questi questo qui se sei si sia siamo sono sta
su sua sue sugli sui sul sullo sulla sulle suo suoi te ti tra tu tua tue tuo
tuoi tutti tutto un una uno vi voi vostra vostre vostri vostro
""".split())

_LANGS = {
    "english": (STOPWORDS_EN, stem_english),
    "italian": (STOPWORDS_IT, stem_italian),
}

# token→stem memo per language: corpora reuse tokens heavily, and the
# pure-Python Snowball stemmers dominate ingest cost without it.
# Bounded by churn-on-overflow so adversarial vocabularies can't grow
# it without limit.
_STEM_CACHE_MAX = 1 << 18
_stem_cache: dict[str, dict[str, str]] = {lang: {} for lang in _LANGS}


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def analyze(text: str, language: str = "english") -> list[str]:
    """tokenize → drop stopwords → stem (analyzer.go:21-110)."""
    if language not in _LANGS:
        language = "english"
    stop, stem = _LANGS[language]
    cache = _stem_cache[language]
    out = []
    for t in tokenize(text):
        if t in stop or len(t) <= 1:
            continue
        s = cache.get(t)
        if s is None:
            if len(cache) >= _STEM_CACHE_MAX:
                cache.clear()
            s = cache[t] = stem(t)
        out.append(s)
    return out
