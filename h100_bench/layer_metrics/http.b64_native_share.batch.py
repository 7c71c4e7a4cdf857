"""`server/http.py`: the share of batched-search bodies carrying
`query_vectors_b64` whose queries the host runtime decoded straight from
the raw body (the program's counter `http.queries_b64.native`) among all
such bodies (with `http.queries_b64.fallback`, those parsed whole), over
the serving process's life, warm-up included. None where the program
keeps no such counters."""


def read(ctx):
    try:
        from kektordb_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    native = counts.get("http.queries_b64.native", 0)
    total = native + counts.get("http.queries_b64.fallback", 0)
    return native / total if total else None
