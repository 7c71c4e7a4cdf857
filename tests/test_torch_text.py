"""The port's copy of the text analysis (kektordb_tpu_torch/text) against
the JAX package's kektordb_tpu/text, which it replaces inside the port:
the same BM25 rows and scores on a seeded corpus, with interleaved writes
and removals (exact: both compute the same float64 numpy expressions), and
the same stems for English and Italian word lists."""

import numpy as np
import pytest

from kektordb_tpu.text import analyze as j_analyze
from kektordb_tpu.text import stem_english as j_stem_en
from kektordb_tpu.text import stem_italian as j_stem_it
from kektordb_tpu.text.bm25 import BM25Index as JBM25
from kektordb_tpu_torch.text import analyze, stem_english, stem_italian
from kektordb_tpu_torch.text.bm25 import BM25Index

EN_WORDS = ("running runner runs ran easily fairly generously caresses "
            "ponies ties caress cats feed agreed plastered bled motoring "
            "sing conflated troubled sized hopping tanned falling hissing "
            "fizzed failing filing happy sky dying lying relational "
            "conditional rational valenci hesitanci digitizer conformabli "
            "radicalli differentli vileli analogousli vietnamization "
            "predication operator feudalism decisiveness hopefulness "
            "callousness formaliti sensitiviti sensibiliti triplicate "
            "formative formalize electriciti electrical hopeful goodness "
            "revival allowance inference airliner gyroscopic adjustable "
            "defensible irritant replacement adjustment dependent adoption "
            "homologou communism activate angulariti homologous effective "
            "bowdlerize probate rate cease generate generous news "
            "skies spies succeeded proceeded exceeded dying").split()
IT_WORDS = ("abbandonata abbandonate abbandonati abbandonato abbandonava "
            "abbandonerà abbandonò abbracciamenti abbracciare camminando "
            "cittadinanza cittadini città felicemente fortissimo "
            "gentilmente lavoratori lavorazione mangiavano mangeremmo "
            "operazioni parlarono perché possibilità presidente "
            "rapidamente sognatore stazioni studentessa velocissimi "
            "amichevole ambizione autorizzazione").split()


@pytest.mark.parametrize("lang,words,ref,port", [
    ("english", EN_WORDS, j_stem_en, stem_english),
    ("italian", IT_WORDS, j_stem_it, stem_italian),
])
def test_stemmers_agree(lang, words, ref, port):
    assert [port(w) for w in words] == [ref(w) for w in words]
    text = " ".join(words)
    assert analyze(text, lang) == j_analyze(text, lang)


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(300)] + EN_WORDS
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(vocab, size=rng.integers(4, 14), p=p))
            for _ in range(n)], rng


@pytest.mark.parametrize("language", ["english", "italian"])
def test_bm25_search_arrays_agree(language):
    docs, rng = _corpus(400, seed=21)
    ref, port = JBM25(language), BM25Index(language)
    queries = ["w0 w3 running", "w17", "ponies w1 w2 w250", "absent words",
               "w5 w5 feed"]

    def check():
        for qtext in queries:
            r_rows, r_vals = ref.search_arrays(qtext)
            p_rows, p_vals = port.search_arrays(qtext)
            np.testing.assert_array_equal(p_rows, r_rows)
            np.testing.assert_array_equal(p_vals, r_vals)
        assert port.stats() == ref.stats()
    for i, doc in enumerate(docs[:300]):
        for idx in (ref, port):
            idx.add(i, "body", doc)
            if i % 3 == 0:
                idx.add(i, "title", doc.split()[0])
    check()
    # writes after the snapshot land in the delta; removals override rows
    for i in range(300, 400):
        for idx in (ref, port):
            idx.add(i, "body", docs[i])
    for i in rng.choice(300, 40, replace=False).tolist():
        for idx in (ref, port):
            idx.remove(i)
    check()
