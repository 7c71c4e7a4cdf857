"""`index/hnsw_kernels.py` `beam_search`, its level-0 loop run in blocks
of the iterations between two done checks: the share of those blocks
replayed from a captured CUDA graph (the program's counter
`beam.graph_replays`) among all of them, replayed or run eagerly
(`beam.eager_blocks`), over the serving process's life: the build's
beam, the warm-up and the maintenance refines included. None where the
program keeps no such counters."""


def read(ctx):
    try:
        from kektordb_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    replays = counts.get("beam.graph_replays", 0)
    total = replays + counts.get("beam.eager_blocks", 0)
    return replays / total if total else None
