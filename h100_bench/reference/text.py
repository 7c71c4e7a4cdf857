"""Plain BM25 and hybrid fusion, the reference for a hybrid read.

The semantics restated here are those `Engine.search` documents for a
hybrid query (`text_query` with a query vector, weight `alpha` on the
vector side), written again from the description and not from the
program's code:

- text: tokenize (lower case, runs of letters and digits), drop English
  stopwords and one-letter tokens, Porter2-stem; BM25 with k1 = 1.2,
  b = 0.75 and idf = log(1 + (N - df + 0.5) / (df + 0.5)) over the
  documents that have at least one token, a query token counted as often
  as it occurs in the query;
- vector: the `FETCH_FACTOR * k` nearest rows by exact distance;
- fusion: each branch min-max normalised (the vector branch inverted,
  nearer is higher; a branch whose scores are all equal normalises to 1),
  only the `text_cap(k)` best text candidates kept, fused score
  alpha * vector + (1 - alpha) * text over the union of the candidates, a
  missing branch counting 0; a query whose text matches no document is a
  plain vector read, fused at alpha 1.

The corpus comes as word ids into a vocabulary of lower-case words made
of the letters a-z, joined by spaces into the texts the program indexes;
`check_vocabulary` holds that each such word tokenizes to itself, so the
analysis of a text is the analysis of its words one by one.
"""

from __future__ import annotations

import math
import re

import numpy as np

from .stemmer_en import stem_english

K1 = 1.2
B = 0.75
FETCH_FACTOR = 2          # vector candidates of a hybrid query: 2k
TEXT_CAP = 512            # text candidates kept: max(512, 4k)

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


def text_cap(k: int) -> int:
    return max(TEXT_CAP, 4 * k)


def analyze(text: str) -> list[str]:
    """tokenize -> drop stopwords and one-letter tokens -> stem."""
    return [stem_english(t) for t in _TOKEN_RE.findall(text.lower())
            if t not in STOPWORDS_EN and len(t) > 1]


def check_vocabulary(vocab: list[str]) -> None:
    for w in vocab:
        if _TOKEN_RE.findall(w.lower()) != [w]:
            raise ValueError(f"vocabulary word {w!r} is not one token")


class BM25:
    """BM25 over a corpus given as word ids: `words` the concatenated word
    ids of every document, `offsets` [n_docs + 1] their bounds."""

    def __init__(self, vocab: list[str], words: np.ndarray,
                 offsets: np.ndarray):
        check_vocabulary(vocab)
        terms: dict[str, int] = {}
        word_term = np.full(len(vocab), -1, np.int64)
        for i, w in enumerate(vocab):
            toks = analyze(w)
            if toks:
                word_term[i] = terms.setdefault(toks[0], len(terms))
        self.word_term = word_term
        n_docs = len(offsets) - 1
        doc = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(offsets))
        term = word_term[np.asarray(words, np.int64)]
        keep = term >= 0
        doc, term = doc[keep], term[keep]
        self.doc_len = np.bincount(doc, minlength=n_docs).astype(np.float64)
        has = self.doc_len > 0
        self.n_docs = int(has.sum())
        self.avg_len = float(self.doc_len[has].sum()) / max(self.n_docs, 1)
        key = np.unique(term * n_docs + doc, return_counts=True)
        pair, tf = key
        self.post_term = pair // n_docs
        self.post_doc = pair % n_docs
        self.post_tf = tf.astype(np.float64)
        n_terms = len(terms)
        self.start = np.searchsorted(self.post_term, np.arange(n_terms + 1))

    def scores(self, query_words: np.ndarray) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """(rows ascending, BM25 scores) of every document that holds a
        token of the query."""
        rows_parts, val_parts = [], []
        for t in self.word_term[np.asarray(query_words, np.int64)]:
            if t < 0:
                continue
            s, e = self.start[t], self.start[t + 1]
            if s == e:
                continue
            df = e - s
            idf = math.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
            rows = self.post_doc[s:e]
            tf = self.post_tf[s:e]
            dl = self.doc_len[rows]
            rows_parts.append(rows)
            val_parts.append(
                idf * tf * (K1 + 1) / (tf + K1 * (1 - B + B * dl
                                                   / self.avg_len)))
        if not rows_parts:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        rows = np.concatenate(rows_parts)
        uniq, inv = np.unique(rows, return_inverse=True)
        return uniq, np.bincount(inv, weights=np.concatenate(val_parts))


def fuse(vec_rows: np.ndarray, vec_dist: np.ndarray, text_rows: np.ndarray,
         text_vals: np.ndarray, alpha: float, k: int) -> dict[int, float]:
    """Fused score of every candidate of one query: `vec_rows` /
    `vec_dist` its FETCH_FACTOR * k nearest rows with their exact
    distances, `text_rows` / `text_vals` its BM25 scores."""
    if not text_rows.size:
        alpha = 1.0
    out: dict[int, float] = {}
    text_of: dict[int, float] = {}
    if text_rows.size:
        cap = text_cap(k)
        if text_rows.size > cap:
            # the cap's boundary: rows tied with the cap-th score normalise
            # to 0 whichever of them are kept, so any choice among them
            # gives the same fused scores
            sel = np.argsort(-text_vals, kind="stable")[:cap]
            tr, ts = text_rows[sel], text_vals[sel]
        else:
            tr, ts = text_rows, text_vals
        lo, hi = ts.min(), ts.max()
        tsn = np.ones_like(ts) if hi <= lo else (ts - lo) / (hi - lo)
        text_of = dict(zip(tr.tolist(), tsn.tolist()))
    if vec_rows.size:
        lo, hi = vec_dist.min(), vec_dist.max()
        sim = np.ones_like(vec_dist) if hi <= lo \
            else (hi - vec_dist) / (hi - lo)
        for r, s in zip(vec_rows.tolist(), sim.tolist()):
            out[r] = alpha * s + (1 - alpha) * text_of.get(r, 0.0)
    for r, t in text_of.items():
        if r not in out:
            out[r] = (1 - alpha) * t
    return out
