"""The port's spans (kektordb_tpu_torch/tracing.py) on the served read.

* A batched b64 request and two single requests coalesced by the batcher,
  through an aiohttp test server on a small Engine: each HTTP request's
  spans share one request id and nest by parent and by time; the
  requests' `batcher.wait` spans name the `batcher.batch` span, under
  which the batch's `engine.search` (n = 2) nests; `/metrics` exports the
  span sums.
* A search that arrives while another holds the lock's shared side: its
  `engine.lock` span covers the rest of the first's shared section.
* The ring drops its oldest span when full and counts the drop; totals
  lose no update under many threads.
* Under torch.profiler the spans are `record_function` ranges whose
  starts agree with the ring's, on other threads too where the profiler
  asks for every thread; with no profiler no range is opened.
"""

import asyncio
import base64
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from kektordb_tpu_torch import tracing
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.server import make_app

DIM, N = 8, 64


@pytest.fixture
def engine():
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    # served as the benchmark's SIFT cell serves: the HNSW index's scan
    e.create_index("T", serve_mode="scan")
    rng = np.random.default_rng(7)
    e.add_batch("T", [str(i) for i in range(N)],
                rng.standard_normal((N, DIM)).astype(np.float32))
    yield e
    e.close()


def _tree_nests(spans):
    """Every span of a request has its parent in the same request and
    lies inside it in time; one root per request id."""
    by_id = {s.id: s for s in spans}
    roots = {}
    for s in spans:
        if s.parent == 0:
            assert s.request not in roots, s
            roots[s.request] = s
            continue
        p = by_id[s.parent]
        assert p.request == s.request, (s, p)
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    return roots


def _served(engine, monkeypatch):
    """Run the three requests against `make_app(engine)`; the spans they
    recorded and the /metrics text."""
    from aiohttp.test_utils import TestClient, TestServer

    # a window wide enough that the two single requests always coalesce
    monkeypatch.setenv("KEKTOR_BATCH_WINDOW_MS", "2000")
    q = np.random.default_rng(3).standard_normal((4, DIM)).astype(np.float32)
    t0 = tracing.now()

    async def main():
        async with TestClient(TestServer(make_app(engine))) as client:
            r = await client.post("/vector/actions/search", json={
                "index_name": "T", "k": 3, "columnar": True, "wire": "b64",
                "query_vectors_b64": base64.b64encode(q.tobytes()).decode(),
                "query_shape": [4, DIM]})
            assert r.status == 200, await r.text()
            assert (await r.json())["shape"] == [4, 3]
            singles = await asyncio.gather(*(
                client.post("/vector/actions/search", json={
                    "index_name": "T", "k": 3,
                    "query_vector": q[i].tolist()}) for i in range(2)))
            for r in singles:
                assert r.status == 200, await r.text()
                assert len((await r.json())["results"]) == 3
            r = await client.get("/metrics")
            return await r.text()

    text = asyncio.run(main())
    return tracing.since(t0), text


def test_served_requests_nest_under_one_request_id(engine, monkeypatch):
    spans, metrics_text = _served(engine, monkeypatch)
    roots = _tree_nests(spans)
    http = [r for r in roots.values() if r.name == "http.request"]
    assert len(http) == 4                     # 3 searches and /metrics
    by_req = {}
    for s in spans:
        by_req.setdefault(s.request, []).append(s)
    names = [sorted({s.name for s in by_req[r.request]}) for r in http]
    batched = ["engine.assemble", "engine.lock", "engine.scan",
               "engine.search", "engine.settle", "http.body",
               "http.decode", "http.encode", "http.request"]
    single = ["batcher.wait", "http.body", "http.decode", "http.encode",
              "http.request"]
    assert names.count(batched) == 1 and names.count(single) == 2, names

    (search,) = [s for s in spans if s.name == "engine.search"
                 and s.request in {r.request for r in http}]
    assert search.n == 4
    (batch,) = [s for s in spans if s.name == "batcher.batch"]
    assert batch.parent == 0 and batch.n == 2
    coalesced = [s for s in by_req[batch.request]
                 if s.name == "engine.search"]
    assert len(coalesced) == 1 and coalesced[0].n == 2
    assert coalesced[0].parent == batch.id
    waits = [s for s in spans if s.name == "batcher.wait"]
    assert len(waits) == 2
    for w in waits:
        assert w.link == batch.id and w.request != batch.request
        assert roots[w.request].name == "http.request"
        # a request waits until its batch's search starts
        assert w.end_ns <= coalesced[0].start_ns

    for series in ("kektordb_span_seconds_sum", "kektordb_span_seconds_count",
                   "kektordb_span_cpu_seconds_sum"):
        for name in ("http.request", "engine.search", "batcher.batch"):
            assert f'{series}{{name="{name}"}} ' in metrics_text
    assert "kektordb_spans_dropped_total " in metrics_text


def test_a_search_waiting_on_the_shared_side_shows_it(engine):
    """The second search takes the exclusive side to settle, so it waits
    for the first's whole shared section: its engine.lock span covers the
    moment the first one is let go."""
    idx = engine._handle("T").index
    inner, held, release = idx.search, threading.Event(), threading.Event()

    def slow_search(*a, **kw):
        if threading.current_thread().name == "first":
            held.set()
            assert release.wait(30)
        return inner(*a, **kw)

    idx.search = slow_search
    q = np.zeros((1, DIM), np.float32)
    t0 = tracing.now()
    first = threading.Thread(target=engine.search, args=("T", q),
                             name="first")
    second = threading.Thread(target=engine.search, args=("T", q),
                              name="second")
    first.start()
    assert held.wait(30)
    second.start()
    deadline = time.monotonic() + 30
    while engine._lock._writers_waiting == 0:
        assert time.monotonic() < deadline, "the second search never waited"
        time.sleep(0.001)
    let_go = tracing.now()
    release.set()
    for t in (first, second):
        t.join(30)
        assert not t.is_alive()

    spans = tracing.since(t0)
    first_s, second_s = sorted((s for s in spans if s.name == "engine.search"),
                               key=lambda s: s.start_ns)
    (lock2,) = [s for s in spans if s.name == "engine.lock"
                and s.parent == second_s.id]
    (scan1,) = [s for s in spans if s.name == "engine.scan"
                and s.parent == first_s.id]
    assert lock2.start_ns < let_go < scan1.end_ns <= lock2.end_ns


def test_ring_drops_its_oldest_span_and_counts_it():
    rec = tracing.Recorder(size=4)
    for i in range(6):
        rec.record("s", i + 1, 0, i + 1, i, i + 1, 0)
    rec.count("c", 3)
    assert [s.id for s in rec.since()] == [3, 4, 5, 6]
    assert rec.dropped() == 2
    assert rec.totals()["s"] == (6, 6, 0)
    assert rec.totals()["c"] == (3, 0, 0)


def test_totals_lose_no_update_across_threads():
    rec = tracing.Recorder(size=1024)
    per, threads = 3000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(per):
                rec.record("s", i, 0, 1, 0, 2, 1)
                rec.count("c")
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    tot = rec.totals()
    assert tot["s"] == (per * threads, 2 * per * threads, per * threads)
    assert tot["c"][0] == per * threads
    assert rec.dropped() == per * threads - 1024
    assert len(rec.since()) == 1024
    # a finished thread's totals stay once folded
    assert rec.totals() == tot


def test_no_profiler_no_range(engine, monkeypatch):
    """Without a profiler session the spans and the kernel ranges call
    no record_function."""
    def refuse(*a, **kw):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.profiling()
    engine.search("T", np.zeros((2, DIM), np.float32), k=3)
    with tracing.kernel_range("scan.pass_a"):
        pass


def test_spans_are_profiler_ranges_on_the_ring_clock(engine):
    """Under torch.profiler every span is a range of its name, and its
    start, put on the ring's clock by align ranges as the benchmark's
    Profile does, is the ring's within 1 ms (medians, so that a thread
    preempted between two clock readings on a loaded host does not
    decide)."""
    q = np.random.default_rng(5).standard_normal((3, DIM)).astype(
        np.float32)
    names = ("engine.search", "engine.scan", "engine.assemble",
             "engine.settle")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aligns = []
        for _ in range(5):
            aligns.append(time.perf_counter_ns())
            with record_function("align"):
                pass
        t0 = tracing.now()
        for _ in range(5):
            engine.search("T", q, k=3)
    spans = [s for s in tracing.since(t0) if s.name in names]
    events = prof.profiler.kineto_results.events()
    starts = sorted(e.start_ns() for e in events if e.name() == "align")
    assert len(starts) == len(aligns)
    offset = statistics.median(e - a for e, a in zip(starts, aligns))
    assert len(spans) == 5 * len(names)
    for name in names:
        ring = sorted(s.start_ns for s in spans if s.name == name)
        ranges = sorted(e.start_ns() - offset for e in events
                        if e.name() == name)
        assert len(ranges) == len(ring), name
        gap = statistics.median(r - s for r, s in zip(ranges, ring))
        assert abs(gap) < 1_000_000, (name, gap)


def test_span_cost_probe_runs_and_sees_every_thread(monkeypatch):
    """The probe's profiler, started as `/debug/profile` starts one,
    records the ranges of another thread's spans."""
    from kektordb_tpu_torch.probes import span_cost

    monkeypatch.setattr(span_cost, "N", 1000)
    out = span_cost.run()
    assert out["profiling_seen"] and out["all_threads_option"]
    assert out["other_thread_ranges"] == 3
    assert all(out[f"span_cpu_ns_{r}"] > 0 for r in range(3))
