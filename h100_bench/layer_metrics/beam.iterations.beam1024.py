"""`index/hnsw_kernels.py` `beam_search` as the beam read runs it: its
host loop's iterations a search (the counters `beam.iterations` over
`beam.searches`, over the serving process's life, warm-up included).
None where the program keeps no such counters."""


def read(ctx):
    try:
        from kektordb_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    searches = counts.get("beam.searches", 0)
    if not searches or "beam.iterations" not in counts:
        return None
    return counts["beam.iterations"] / searches
