"""The beam read's gather-distance kernels (`ops/distance.py` gathered,
`csrc/gather_dist.cu`) against their roofline.

The work counted is the search's: every neighbour id the beam scores
(the program's counter `beam.scored`, ids that are not already in a
query's pools, its history or earlier in the same gather) needs its row
read once and its id and distance moved, 4 + 4 bytes. Its least time on
the card is those bytes at the HBM peak (the product, 2 D operations a
row, is far below the compute peak). It is divided by the device time of
the kernels named `gather_dist` that run inside the program's
`index.beam` spans in the traced slice; the searches counted are those
spans, each by the share of it inside the slice, at the mean ids scored
a search (`beam.scored` over `beam.searches`, warm-up included). The
descent's calls run before `index.beam` opens and are left out on both
sides. None where the program records no such span or counter.
"""

import bisect

ROW_BYTES = {"float32": 4, "bfloat16": 2}


def bytes_moved(scored: float, d: int, precision: str) -> float:
    return scored * (ROW_BYTES[precision] * d + 8.0)


def bound_s(scored, d, precision, peaks) -> float:
    return bytes_moved(scored, d, precision) / peaks["hbm_byte_per_s"]


def _beam_spans(lo_ns: int, hi_ns: int):
    try:
        from kektordb_tpu_torch import tracing
    except ImportError:
        return None, None
    counts = tracing.counters()
    if not counts.get("beam.searches") or "beam.scored" not in counts:
        return None, None
    spans = [(s.start_ns, s.end_ns) for s in tracing.since(0)
             if s.name == "index.beam" and s.end_ns > lo_ns
             and s.start_ns < hi_ns]
    return spans, counts["beam.scored"] / counts["beam.searches"]


def read(ctx):
    events, window = ctx.device_events()
    if events is None:
        return None
    lo, hi = window
    spans, per_search = _beam_spans(int(lo * 1e9), int(hi * 1e9))
    if not spans:
        return None
    spans = sorted((s / 1e9, e / 1e9) for s, e in spans)
    # the union of the spans (two clients' searches may overlap)
    starts, ends = [], []
    for s, e in spans:
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)

    def in_beam(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    kernel_s = sum(min(e, hi) - max(s, lo) for name, s, e in events
                   if "gather_dist" in name and e > lo and s < hi
                   and in_beam((s + e) / 2))
    searches = sum((min(e, hi) - max(s, lo)) / (e - s)
                   for s, e in spans if e > s)
    if kernel_s <= 0 or searches <= 0:
        return None
    d = int(ctx.config["dataset"]["dim"])
    precision = ctx.config["index"]["precision"]
    need = bound_s(searches * per_search, d, precision, ctx.peaks)
    ctx.note(f"gather roofline: {searches!r} searches in the slice, "
             f"{per_search!r} ids scored a search, bound {need!r} s; "
             f"{kernel_s!r} s of gather_dist kernels in index.beam")
    return 100.0 * need / kernel_s
