"""`index/hnsw.py` `HNSWIndex.search`, the beam read: the mean
`index.beam` span, the level-0 beam (`hnsw_kernels.beam_search`: its
host loop, the gather-distance calls, the pools' sorts) through the copy
of the answers back. None where the program records no such span."""

from harness.program_spans import requests


def read(ctx):
    reqs = requests(ctx)
    beams = [] if reqs is None else reqs.named("index.beam")
    if not beams:
        return None
    return sum(s.end_ns - s.start_ns for s in beams) / len(beams) / 1e6
