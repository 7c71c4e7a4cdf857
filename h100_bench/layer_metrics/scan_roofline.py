"""The scan read's share of its roofline: `ops/scan.py` (pass A,
`csrc/scan_pass_a_wgmma.cu`; pass B's top-k) and the exact re-rank
(`ops/distance.py` gathered, `csrc/gather_dist.cu`).

The work counted is the search's, whatever implements it: a batch of B
queries against N rows of D float32 dimensions, k answers each. Its
least time on the card is the larger of the products at the bf16 dense
peak (the precision in which the serving read issues them) and the bytes
at the HBM peak: the rows read once, the queries read once, k distances
and k ids written per query. It is divided by the device time of every
kernel in the traced slice (in this cell every kernel belongs to a
search), per search; a search that straddles the slice's edge counts by
the share of its span inside the slice.
"""


def ops(b: int, n: int, d: int) -> float:
    return 2.0 * b * n * d


def bytes_moved(b: int, n: int, d: int, k: int) -> float:
    return 4.0 * n * d + 4.0 * b * d + 8.0 * b * k


def bound_s(b, n, d, k, peaks) -> float:
    return max(ops(b, n, d) / peaks["bf16_flop_per_s"],
               bytes_moved(b, n, d, k) / peaks["hbm_byte_per_s"])


def read(ctx):
    events, window = ctx.device_events()
    if events is None:
        return None
    lo, hi = window
    kernel_s = sum(min(e, hi) - max(s, lo) for name, s, e in events
                   if e > lo and s < hi
                   and not name.startswith(("Memcpy", "Memset")))
    ds = ctx.config["dataset"]
    n, d, k = int(ds["rows"]), int(ds["dim"]), int(ctx.mix["k"])
    need = 0.0
    for s, e, b in ctx.search_spans(outside_slice=False):
        inside = min(e, hi) - max(s, lo)
        if inside > 0 and e > s:
            need += inside / (e - s) * bound_s(b, n, d, k, ctx.peaks)
    if kernel_s <= 0 or need <= 0:
        return None
    b = int(ctx.mix.get("batch", 1))
    ctx.note(f"roofline: bound {bound_s(b, n, d, k, ctx.peaks) * 1e3!r} "
             f"ms a search of {b} queries; {kernel_s!r} s of kernels in "
             f"the {hi - lo!r} s slice")
    return 100.0 * need / kernel_s
