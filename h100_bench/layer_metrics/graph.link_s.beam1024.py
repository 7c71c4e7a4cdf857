"""`index/hnsw.py` graph build: the seconds of the `graph.link` spans
(one a chunk of rows: the beam at ef_construction, the intra-chunk
candidates, `graph.select`, the link commit, `graph.upper`) summed over
the serving process's life, which is the set-up's bulk load. None where
the program records no such span."""


def read(ctx):
    try:
        from kektordb_tpu_torch import tracing
    except ImportError:
        return None
    link = tracing.totals().get("graph.link")
    return None if link is None else link[1] / 1e9
