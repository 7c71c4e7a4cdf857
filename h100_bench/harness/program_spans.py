"""The program's own spans, as the per-layer readers read them.

The port records every span of the serving process (this one) into its
ring (`kektordb_tpu_torch/tracing.py`): name, id, parent, request id,
start and end on the host's monotonic clock, the thread's CPU time over
it, its work count, and the span it waited for (`link`). A request is
the spans of one request id; its root is the span with no parent
(`http.request` for an HTTP request, `batcher.batch` for a batch the
batcher ran). A reader keeps the requests whose root starts inside the
window and does not touch the traced slice or the reading of its trace,
by `Context._outside`'s rule, and every span of a request with it; the
device-trace reader takes the spans inside the slice instead. Against a
program that records no spans every reader returns None.
"""

from __future__ import annotations

import heapq

BODY, DECODE, ENCODE = "http.body", "http.decode", "http.encode"
REQUEST, WAIT, SEARCH = "http.request", "batcher.wait", "engine.search"
ENGINE_PARTS = ("engine.lock", "engine.settle", "engine.text", "engine.scan",
                "engine.fuse", "engine.assemble")


def _ring():
    """Every span the program's ring holds, or None where the program
    has no ring."""
    try:
        from kektordb_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.since(0)


class Requests:
    """The window's requests, each a list of spans (`kept`), and every
    request's spans by its root's id (`by_root`), which a `link` names."""

    def __init__(self, ctx, spans):
        lo, hi = ctx.window
        groups: dict[int, list] = {}
        for s in spans:
            groups.setdefault(s.request, []).append(s)
        self.by_root: dict[int, list] = {}
        self.kept: list[tuple] = []          # (root, spans)
        for ss in groups.values():
            roots = [s for s in ss if s.parent == 0]
            if len(roots) != 1:
                continue
            root = roots[0]
            self.by_root[root.id] = ss
            t0, t1 = root.start_ns / 1e9, root.end_ns / 1e9
            if lo <= t0 < hi and ctx._outside([(t0, t1)]):
                self.kept.append((root, ss))

    def http(self):
        return [(r, ss) for r, ss in self.kept if r.name == REQUEST]

    def named(self, name: str):
        return [s for _, ss in self.kept for s in ss if s.name == name]


def requests(ctx) -> Requests | None:
    spans = _ring()
    if spans is None:
        return None
    reqs = Requests(ctx, spans)
    return reqs if reqs.kept else None


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def per_request_ms(ctx, names: tuple[str, ...]) -> float | None:
    """Mean over HTTP requests of the wall time of their spans named in
    `names`."""
    reqs = requests(ctx)
    if reqs is None or not reqs.http():
        return None
    http = reqs.http()
    return sum(_ms(s) for _, ss in http for s in ss
               if s.name in names) / len(http)


def per_search_ms(ctx, name: str) -> float | None:
    """Mean over `Engine.search` calls of the wall time of their spans
    named `name`."""
    reqs = requests(ctx)
    if reqs is None:
        return None
    searches = reqs.named(SEARCH)
    if not searches:
        return None
    return sum(_ms(s) for s in reqs.named(name)) / len(searches)


def _union_ns(intervals, lo: int, hi: int) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _searches(reqs: Requests, ss) -> list:
    """The `Engine.search` spans a request waited for: its own, and
    those of the batches its `batcher.wait` spans link to."""
    out = [s for s in ss if s.name == SEARCH]
    for s in ss:
        if s.name == WAIT and s.link in reqs.by_root:
            out += [x for x in reqs.by_root[s.link] if x.name == SEARCH]
    return out


def self_ms(ctx) -> float | None:
    """Mean over HTTP requests of the root's wall time less what its
    child spans and the searches it waited for cover."""
    reqs = requests(ctx)
    if reqs is None or not reqs.http():
        return None
    out = []
    for root, ss in reqs.http():
        cover = [(s.start_ns, s.end_ns) for s in ss if s.parent == root.id]
        cover += [(s.start_ns, s.end_ns) for s in _searches(reqs, ss)]
        covered = _union_ns(cover, root.start_ns, root.end_ns)
        out.append((root.end_ns - root.start_ns - covered) / 1e6)
    return sum(out) / len(out)


def decomposition(ctx) -> dict | None:
    """Mean ms per HTTP request: the request, its parse (body and
    decode), batcher wait, encode, self time and the searches it waited
    for; and per search its parts."""
    reqs = requests(ctx)
    if reqs is None or not reqs.http():
        return None
    http = reqs.http()
    n = len(http)
    out = {"requests": n,
           "request": sum(_ms(r) for r, _ in http) / n,
           "parse": per_request_ms(ctx, (BODY, DECODE)),
           "wait": per_request_ms(ctx, (WAIT,)),
           "encode": per_request_ms(ctx, (ENCODE,)),
           "self": self_ms(ctx),
           "search": sum(_ms(s) for _, ss in http
                         for s in _searches(reqs, ss)) / n}
    for part in ENGINE_PARTS:
        out[part] = per_search_ms(ctx, part)
    out["per search"] = per_search_ms(ctx, SEARCH)
    return out


def note_decomposition(ctx) -> None:
    d = decomposition(ctx)
    if d is None:
        return
    parts = d["parse"] + d["wait"] + d["encode"] + d["self"] + d["search"]
    engine = sum(d[p] for p in ENGINE_PARTS)
    ctx.note(f"request: {d['requests']} requests, {d['request']!r} ms = "
             f"parse {d['parse']!r} + batcher.wait {d['wait']!r} + encode "
             f"{d['encode']!r} + self {d['self']!r} + engine.search "
             f"{d['search']!r} (sum {parts!r}); a search "
             f"{d['per search']!r} ms: "
             + ", ".join(f"{p[7:]} {d[p]!r}" for p in ENGINE_PARTS)
             + f" (sum {engine!r})")


def outside_ms(ctx) -> float | None:
    """Mean client latency (send to answer) less the mean `http.request`
    span: what the server does before and after its middleware (the
    header read, the response write) and the wire."""
    reqs = requests(ctx)
    client = ctx.client_spans()
    if reqs is None or not reqs.http() or not client:
        return None
    http = reqs.http()
    req_ms = sum(_ms(r) for r, _ in http) / len(http)
    return sum(e - s for s, e in client) * 1e3 / len(client) - req_ms


def offcpu_share(ctx, names: tuple[str, ...]) -> float | None:
    """1 - the threads' CPU time over the wall time, summed over the
    spans named in `names`."""
    reqs = requests(ctx)
    if reqs is None:
        return None
    spans = [s for _, ss in reqs.kept for s in ss if s.name in names]
    wall = sum(s.end_ns - s.start_ns for s in spans)
    if wall <= 0:
        return None
    return 1.0 - sum(s.cpu_ns for s in spans) / wall


def _gaps(events, window):
    lo, hi = window
    gaps, t = [], lo
    for _, s, e in events:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def idle_outside_spans(ctx) -> float | None:
    """The share of the traced slice's device idle time whose gap has
    its middle in no program span; notes the idle seconds by the deepest
    span that covers each gap's middle."""
    events, window = ctx.device_events()
    spans = _ring()
    if events is None or spans is None:
        return None
    lo, hi = int(window[0] * 1e9), int(window[1] * 1e9)
    spans = [s for s in spans if s.end_ns > lo and s.start_ns < hi]
    if not spans:
        return None
    by_id = {s.id: s for s in spans}
    depth: dict[int, int] = {}

    def depth_of(s) -> int:
        if s.id not in depth:
            p = by_id.get(s.parent)
            depth[s.id] = 0 if p is None else depth_of(p) + 1
        return depth[s.id]

    by_start = sorted(spans, key=lambda s: s.start_ns)
    active: list = []        # heap of (end, id)
    i = 0
    idle: dict[str, float] = {}
    for g0, g1 in _gaps(events, window):
        mid = int((g0 + g1) / 2 * 1e9)
        while i < len(by_start) and by_start[i].start_ns <= mid:
            heapq.heappush(active, (by_start[i].end_ns, by_start[i].id))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = "none"
        if active:
            deepest = max((by_id[sid] for _, sid in active),
                          key=lambda s: (depth_of(s), s.start_ns))
            name = deepest.name
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    total = sum(idle.values())
    if total <= 0:
        return None
    ctx.note("device idle by program span: " + ", ".join(
        f"{n} {s!r} s" for n, s in sorted(idle.items(),
                                           key=lambda kv: -kv[1]))
        + f" (of {total!r} s idle in the {window[1] - window[0]!r} s "
        "slice)")
    return idle.get("none", 0.0) / total
