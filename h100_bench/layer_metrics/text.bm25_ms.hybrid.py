"""`text/bm25.py`: the mean span of the text store's `search_arrays`
(analysis of the question and its BM25 over the postings)."""

from harness.layers import mean_ms


def read(ctx):
    return mean_ms(ctx.text_spans())
