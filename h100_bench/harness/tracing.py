"""Spans and the device trace of a `--trace 1` run, taken from the
benchmark's own code around the program's calls.

- `Spans` wraps, on the instances this run built, `Engine.search` and the
  BM25 store's `search_arrays`: each call's start and end on the host's
  monotonic clock, and its batch (queries in the call); inside a
  `torch.profiler.record_function` range named after its layer
  ("engine", "text").
- `Profile` traces the card with `torch.profiler` (CPU and CUDA
  activities) over a slice of the window, from the main thread, which is
  idle while the clients run. An empty range recorded at a known host
  time ties the profiler's clock to the host's.
"""

from __future__ import annotations

import bisect
import time


class Spans:
    def __init__(self, engine, index: str):
        from torch.profiler import record_function

        self.search: list[tuple[float, float, int]] = []
        self.text: list[tuple[float, float]] = []
        search = engine.search

        def traced_search(index_, query, *a, **kw):
            t0 = time.perf_counter()
            try:
                with record_function("engine"):
                    return search(index_, query, *a, **kw)
            finally:
                n = len(query) if getattr(query, "ndim", 1) > 1 else 1
                self.search.append((t0, time.perf_counter(), n))

        engine.search = traced_search
        store = engine._handle(index).meta.text
        text = store.search_arrays

        def traced_text(*a, **kw):
            t0 = time.perf_counter()
            try:
                with record_function("text"):
                    return text(*a, **kw)
            finally:
                self.text.append((t0, time.perf_counter()))

        store.search_arrays = traced_text


class Profile:
    """torch.profiler over [t_from, t_to] on the host's clock."""

    def __init__(self, t_from: float, t_to: float):
        self.t_from, self.t_to = t_from, t_to
        self.events = None       # device operations: (name, start, end)
        self.window = None       # (start, end) actually traced
        self.done = None         # when the trace had been read
        self.error = None

    def run(self) -> None:
        """Sleep until the slice, trace it, read the trace."""
        try:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            wait = self.t_from - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            with profile(activities=acts) as prof:
                a0 = time.perf_counter_ns()
                with record_function("h100_bench.align"):
                    pass
                start = time.perf_counter()
                wait = self.t_to - start
                if wait > 0:
                    time.sleep(wait)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                end = time.perf_counter()
            self._read(prof, a0, start, end)
        except Exception as e:  # noqa: BLE001 - reported with the metrics
            self.error = repr(e)
        self.done = time.perf_counter()

    def _read(self, prof, a0: int, start: float, end: float) -> None:
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        align = [e for e in events if e.name() == "h100_bench.align"]
        offset = align[0].start_ns() - a0 if align else 0
        dev = []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                s = (e.start_ns() - offset) / 1e9
                dev.append((e.name(), s, s + e.duration_ns() / 1e9))
        self.events = sorted(dev, key=lambda x: x[1])
        self.window = (start, end)


def union_seconds(spans: list[tuple[float, float]], lo: float,
                  hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one span."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans
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


def idle_gaps(events, window, ranges: dict[str, list]) -> list[tuple]:
    """Gaps between device operations inside `window`, each named by the
    first host range (in `ranges`' order) that covers its middle, or
    "other": [(name, seconds)]."""
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
    merged = {n: _merge(spans) for n, spans in ranges.items()}
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        name = next((n for n, (starts, ends) in merged.items()
                     if _covers(starts, ends, mid)), "other")
        named.append((name, e - s))
    return named


def _merge(spans) -> tuple[list[float], list[float]]:
    starts, ends = [], []
    for s, e in sorted(spans):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _covers(starts, ends, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]
