"""Passages and questions for a hybrid read, made on the device from the
seed: unit vectors from the repository's clustered-cosine generator
(bench.py's 384-d collection: normal centroids plus normal noise, then
normalised) and texts drawn from one Zipf vocabulary.

The vocabulary's most frequent words are English stopwords (the
analyzer drops them, as it drops them from real text), the rest made-up
words of three consonant-vowel syllables, lower-case a-z only, so that a
text is its words joined by spaces and each word is one token. Passage
and question lengths are log-normal around the source's mean word
counts. A question is written about one passage: its vector is drawn
from that passage's cluster and `from_source` of its words are taken
from that passage, the rest from the vocabulary.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STOPWORDS = sorted(set("""
a about above after again against all am an and any are as at be because been
before being below between both but by can did do does doing down during each
few for from further had has have having he her here hers herself him himself
his how i if in into is it its itself just me more most my myself no nor not
now of off on once only or other our ours ourselves out over own same she
should so some such than that the their theirs them themselves then there
these they this those through to too under until up very was we were what
when where which while who whom why will with you your yours yourself
yourselves
""".split()))

_CONS = "bcdfghjklmnprstvz"
_VOWS = "aeiou"
_SYL = [c + v for c in _CONS for v in _VOWS]


def vocabulary(size: int) -> list[str]:
    """The stopwords, then made-up words until `size` words: the same
    list for every seed."""
    n_syl = len(_SYL)
    space = n_syl ** 3
    words = list(STOPWORDS)
    i = 0
    seen = set(words)
    while len(words) < size:
        j = (i * 7919 + 12345) % space
        i += 1
        w = _SYL[j // n_syl ** 2] + _SYL[(j // n_syl) % n_syl] \
            + _SYL[j % n_syl]
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _lengths(g, n, mean, sigma, lo, hi, device):
    mu = math.log(mean) - sigma * sigma / 2
    x = torch.exp(mu + sigma * torch.randn(n, generator=g, device=device))
    return x.round().clamp_(lo, hi).long()


def _zipf(g, n, cdf, device):
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def _join(vocab: np.ndarray, words: np.ndarray, offsets: np.ndarray):
    return [" ".join(vocab[words[a:b]])
            for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def make(cfg: dict, seed: int, device: torch.device) -> dict:
    ds, tx = cfg["dataset"], cfg["text"]
    n, d, nq = int(ds["rows"]), int(ds["dim"]), int(ds["queries"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cents = torch.randn(int(ds["clusters"]), d, generator=g, device=device)
    noise = float(ds["noise"])

    def vectors(which):
        v = cents[which] + noise * torch.randn(which.numel(), d,
                                               generator=g, device=device)
        return v / (torch.linalg.vector_norm(v, dim=1, keepdim=True)
                    + 1e-12)

    which = torch.randint(0, cents.shape[0], (n,), generator=g,
                          device=device)
    rows = vectors(which)
    vocab = vocabulary(int(tx["vocabulary"]))
    rank = torch.arange(1, len(vocab) + 1, device=device,
                        dtype=torch.float64)
    p = rank ** -float(tx["zipf_s"])
    cdf = torch.cumsum(p / p.sum(), 0)
    dl = _lengths(g, n, tx["passage_words_mean"], tx["passage_sigma"],
                  tx["passage_words_min"], tx["passage_words_max"], device)
    doff = torch.zeros(n + 1, dtype=torch.long, device=device)
    doff[1:] = torch.cumsum(dl, 0)
    dwords = _zipf(g, int(doff[-1]), cdf, device)
    src = torch.randint(0, n, (nq,), generator=g, device=device)
    queries = vectors(which[src])
    ql = _lengths(g, nq, tx["question_words_mean"], tx["question_sigma"],
                  tx["question_words_min"], tx["question_words_max"],
                  device)
    qoff = torch.zeros(nq + 1, dtype=torch.long, device=device)
    qoff[1:] = torch.cumsum(ql, 0)
    owner = torch.repeat_interleave(src, ql)
    pick = doff[owner] + (torch.rand(owner.numel(), generator=g,
                                     device=device) * dl[owner]).long()
    from_src = torch.rand(owner.numel(), generator=g, device=device) \
        < float(tx["from_source"])
    qwords = torch.where(from_src, dwords[pick],
                         _zipf(g, owner.numel(), cdf, device))
    vocab_np = np.array(vocab)
    dwords_np, doff_np = dwords.cpu().numpy(), doff.cpu().numpy()
    qwords_np, qoff_np = qwords.cpu().numpy(), qoff.cpu().numpy()
    return {"metric": ds["metric"], "rows": rows, "queries": queries,
            "vocab": vocab, "doc_words": dwords_np, "doc_offsets": doff_np,
            "query_words": qwords_np, "query_offsets": qoff_np,
            "texts": _join(vocab_np, dwords_np, doff_np),
            "query_texts": _join(vocab_np, qwords_np, qoff_np)}
