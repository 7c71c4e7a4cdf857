"""Spans of the served read: the program's flight recorder.

A span is one step of a request or of a call: its name, its id, its
parent's id (0 at a root), the request id it belongs to, its start and
end on `time.perf_counter_ns()` (CLOCK_MONOTONIC, the clock a profiler
trace is mapped onto), the thread's CPU time over it
(`time.thread_time_ns()` at each end: for a span across `await`s the
event loop thread's, other tasks' included; 0 for a `Pending` span,
which ends on another thread), the work count `n` (queries in the
call, 0 where a step has none) and `link`, the id of a span it waited
for (a request's `batcher.wait` names the `batcher.batch` that served
it), or 0.

Spans are always recorded, into a ring of `RING` spans kept in memory:
when it is full the oldest span goes and `dropped()` counts it.
Recording takes no lock beyond the interpreter's: the ring is a
`deque`, and each thread keeps its own totals per span name (count,
wall, CPU) for `/metrics`, summed when read. The request id and the
current span live in a `contextvars` variable, which `asyncio` tasks
and `asyncio.to_thread` carry along: a span opened with no span open
is a root and starts a new request id.

While a `torch.profiler` session is active, each span also opens a
`record_function` range of its name, and `kernel_range(name)` names a
kernel wrapper's launches; without a session neither calls into torch.

    with tracing.span("engine.search", n=B):
        ...
    tracing.since(t_ns)        # the spans that started at or after t_ns

The spans the program records:
  http.request, http.body, http.decode, http.encode   server/http.py
  batcher.wait, batcher.batch                         server/batcher.py
  engine.search and under it engine.lock, engine.settle, engine.text,
    engine.scan (the index's search: the scan, or under serve_mode
    "beam" the graph's descent and beam), engine.fuse, engine.assemble
                                                      engine/engine.py
  index.descend, index.beam (the beam read, through its copy back)
  graph.link (one chunk of rows linked), graph.select, graph.upper
                                                      index/hnsw.py
and the counters: engine.search_retries, http.queries_b64.native and
.fallback, beam.searches, beam.iterations, beam.done_checks (the beam
loop's host-device synchronisations), beam.scored (neighbour ids
scored), beam.graph_replays, beam.graph_captures and beam.eager_blocks
(every beam's blocks of iterations between two done checks: replayed
from a CUDA graph, captured, run eagerly; hnsw_kernels.py),
graph.linked_rows, graph.adopted_rows (rows a link pass left
unreachable and the build linked). Kernel wrappers' profiler ranges:
scan.pass_a, scan.pass_b, distance.gathered, fuse.fused_topk, hnsw.beam,
hnsw.link.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler

RING = 1 << 17

_now = time.perf_counter_ns
_cpu = time.thread_time_ns
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
# (request id, span id) of the innermost open span of this context
_current: contextvars.ContextVar[Optional[tuple[int, int]]] = \
    contextvars.ContextVar("kektordb_span", default=None)
_NO_RANGE = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    id: int
    parent: int
    request: int
    start_ns: int
    end_ns: int
    cpu_ns: int
    n: int
    link: int


def profiling() -> bool:
    """Whether a torch.profiler session is active in this process."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def kernel_range(name: str):
    """A profiler range named `name` while a session is active, else a
    context manager that does nothing. Records no span."""
    if profiling():
        return _autograd_profiler.record_function(name)
    return _NO_RANGE


class Recorder:
    """The ring and the per-name totals."""

    def __init__(self, size: int = RING):
        self.size = size
        self.ring: deque = deque(maxlen=size)
        self._local = threading.local()
        # thread -> its totals; a finished thread's are folded into
        # _retired when read
        self._threads: dict[threading.Thread, dict] = {}
        self._retired: dict[str, list[int]] = {}
        self._read_lock = threading.Lock()
        self.counter_names: set[str] = set()

    def _totals(self) -> dict:
        try:
            return self._local.totals
        except AttributeError:
            t = self._local.totals = {}
            self._threads[threading.current_thread()] = t
            return t

    def record(self, name: str, span_id: int, parent: int, request: int,
               start_ns: int, end_ns: int, cpu_ns: int, n: int = 0,
               link: int = 0) -> None:
        self.ring.append((name, span_id, parent, request, start_ns, end_ns,
                          cpu_ns, n, link))
        tot = self._totals()
        agg = tot.get(name)
        if agg is None:
            agg = tot[name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += end_ns - start_ns
        agg[2] += cpu_ns

    def count(self, name: str, k: int = 1) -> None:
        """Add `k` to the counter `name`, kept with the span totals as a
        count with no time."""
        self.counter_names.add(name)
        tot = self._totals()
        agg = tot.get(name)
        if agg is None:
            agg = tot[name] = [0, 0, 0]
        agg[0] += k

    def totals(self) -> dict[str, tuple[int, int, int]]:
        """Per name: (count, wall ns, thread CPU ns) of every span
        recorded, dropped ones included; for a counter (count, 0, 0)."""
        with self._read_lock:
            out = {k: list(v) for k, v in self._retired.items()}
            for th, tot in list(self._threads.items()):
                done = not th.is_alive()
                for name, (c, w, u) in list(tot.items()):
                    agg = out.setdefault(name, [0, 0, 0])
                    agg[0] += c
                    agg[1] += w
                    agg[2] += u
                    if done:
                        r = self._retired.setdefault(name, [0, 0, 0])
                        r[0] += c
                        r[1] += w
                        r[2] += u
                if done:
                    del self._threads[th]
        return {k: tuple(v) for k, v in out.items()}

    def dropped(self) -> int:
        """Spans pushed out of the full ring."""
        recorded = sum(c for name, (c, w, u) in self.totals().items()
                       if name not in self.counter_names)
        return max(0, recorded - self.size)

    def since(self, t_ns: int = 0) -> list[Span]:
        """The spans in the ring that started at or after `t_ns`, in the
        order they ended."""
        return [Span._make(s) for s in self.ring.copy() if s[4] >= t_ns]


RECORDER = Recorder()


def _identity() -> tuple[int, int, int]:
    """A new span's (id, request id, parent id) in this context."""
    cur = _current.get()
    if cur is None:
        return next(_span_ids), next(_request_ids), 0
    return next(_span_ids), cur[0], cur[1]


class _Span:
    """An open span; `span()` makes one. `seconds` is its wall time once
    it has ended."""

    __slots__ = ("name", "n", "id", "parent", "request", "t0", "cpu0",
                 "seconds", "_token", "_range")

    def __init__(self, name: str, n: int = 0):
        self.name, self.n = name, n
        self.seconds = 0.0

    def __enter__(self) -> "_Span":
        self.id, self.request, self.parent = _identity()
        self._token = _current.set((self.request, self.id))
        self._range = None
        if profiling():
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        # the CPU reading inside the wall one, so that CPU <= wall
        self.t0 = _now()
        self.cpu0 = _cpu()
        return self

    def __exit__(self, *exc) -> None:
        cpu = _cpu() - self.cpu0
        t1 = _now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _current.reset(self._token)
        self.seconds = (t1 - self.t0) / 1e9
        RECORDER.record(self.name, self.id, self.parent, self.request,
                        self.t0, t1, cpu, self.n)


def span(name: str, n: int = 0) -> _Span:
    """A span over a `with` block, the child of the span open in this
    context (a root, with a new request id, where none is)."""
    return _Span(name, n)


class Pending:
    """A span that starts when made and ends when `end()` records it,
    maybe on another thread: it records no CPU time and parents
    nothing."""

    __slots__ = ("name", "id", "parent", "request", "t0")

    def __init__(self, name: str):
        self.name = name
        self.id, self.request, self.parent = _identity()
        self.t0 = _now()

    def end(self, at_ns: Optional[int] = None, link: int = 0) -> None:
        RECORDER.record(self.name, self.id, self.parent, self.request,
                        self.t0, _now() if at_ns is None else at_ns, 0, 0,
                        link)


class Tally:
    """One span for time spent in several places, such as a lock's
    acquisitions over retries, recorded by `close()`: from the first
    acquisition's start for the summed wall time, with the summed thread
    CPU time."""

    __slots__ = ("name", "id", "parent", "request", "t0", "wall", "cpu")

    def __init__(self, name: str):
        self.name = name
        self.id, self.request, self.parent = _identity()
        self.t0 = None
        self.wall = self.cpu = 0

    @contextlib.contextmanager
    def acquiring(self, cm):
        """Enter `cm`, counting the time its entry takes, and hold it for
        the block."""
        t, c = _now(), _cpu()
        with cm:
            self.cpu += _cpu() - c
            self.wall += _now() - t
            if self.t0 is None:
                self.t0 = t
            yield

    def close(self) -> None:
        if self.t0 is not None:
            RECORDER.record(self.name, self.id, self.parent, self.request,
                            self.t0, self.t0 + self.wall, self.cpu)


def count(name: str, k: int = 1) -> None:
    """Add `k` to the counter `name` (`counters()`, `/metrics`)."""
    RECORDER.count(name, k)


def counters() -> dict[str, int]:
    return {k: v[0] for k, v in RECORDER.totals().items()
            if k in RECORDER.counter_names}


def totals() -> dict[str, tuple[int, int, int]]:
    """Per span name: (count, wall ns, thread CPU ns), counters left out."""
    return {k: v for k, v in RECORDER.totals().items()
            if k not in RECORDER.counter_names}


def dropped() -> int:
    return RECORDER.dropped()


def since(t_ns: int = 0) -> list[Span]:
    return RECORDER.since(t_ns)


def now() -> int:
    """The spans' clock, in ns."""
    return _now()
