"""Concurrent serving in the port: readers run in parallel, writers stay
exclusive (the JAX package's tests/test_concurrency.py).

* The reference's five `TestRWLock` cases run against the port's
  `engine/locks.RWLock`: its source is read and every `kektordb_tpu`
  module becomes its `kektordb_tpu_torch` copy.
* test_engine_concurrent_mixed_load_fixed_count: the reference's mixed
  load (`:97`, marked slow there: it runs 6 s on a wall clock) at a fixed
  count of writes: four readers (two filtered) and an `index_info` poller
  run until two writers have each made WRITES adds, deletes and metadata
  updates. Every hit is a string id with a finite score, and no hit is an
  id whose delete was acknowledged before the search began.
* What the JAX package got for free from immutable arrays and the port
  writes in place, under threads: decayed searches beside reinforces (the
  device decay mirror refreshed in place while another reader searches),
  each held to the host path; a host index's first searches at once (the
  projected mirror fitted on the search path, once).
"""

import threading
import time

import numpy as np
from test_torch_port_reference import reference_cases

from kektordb_tpu_torch.engine import Engine, EngineConfig

exec(compile(reference_cases("test_concurrency.py", ["TestRWLock"]),
             "test_concurrency.py", "exec"))


def test_reference_rwlock_cases_were_ported():
    assert RWLock.__module__ == "kektordb_tpu_torch.engine.locks"  # noqa: F821
    assert len([m for m in dir(TestRWLock)                          # noqa: F821
                if m.startswith("test_")]) == 5


ROWS, DIM = 600, 16
WRITES = 150        # per writer
ROUNDS = 8          # of the decay test


def test_engine_concurrent_mixed_load_fixed_count(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    e = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                            start_background=False)).open()
    e.create_index("c", m=8, ef_construction=64)
    e.add_batch("c", [f"v{i}" for i in range(ROWS)], X,
                metadatas=[{"grp": i % 4} for i in range(ROWS)])

    stop = threading.Event()
    errors: list[Exception] = []
    reads = [0] * 4
    writes = [0, 0]
    deleted_at: dict[str, float] = {}

    def reader(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                q = X[r.integers(0, ROWS)]
                t0 = time.monotonic()
                res = e.search("c", q, k=5,
                               filter="grp = 1" if seed % 2 else None)[0]
                for hit in res:
                    assert isinstance(hit["id"], str)
                    assert np.isfinite(hit["score"])
                    gone = deleted_at.get(hit["id"])
                    assert gone is None or gone >= t0, hit
                reads[seed] += 1
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)

    def writer(seed):
        r = np.random.default_rng(1000 + seed)
        try:
            for i in range(WRITES):
                op = r.integers(0, 3)
                victim = f"v{int(r.integers(0, ROWS))}"
                if op == 0:
                    e.add("c", f"w{seed}-{i}",
                          r.normal(size=DIM).astype(np.float32),
                          {"grp": int(r.integers(0, 4)),
                           "body": f"tok{i % 64} alpha note",
                           "_indexed_fields": ["body"]})
                elif op == 1:
                    if e.delete("c", victim):
                        deleted_at[victim] = time.monotonic()
                else:
                    try:
                        e.update_metadata("c", victim,
                                          {"grp": int(r.integers(0, 4))})
                    except KeyError:
                        pass           # the row was deleted: no update
                writes[seed] += 1
                time.sleep(0.002)
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)

    def poller():
        # index_info iterates the text index's write-hot dicts under the
        # read lock
        try:
            while not stop.is_set():
                info = e.index_info("c")
                assert info["size"] >= 0
                for st in info["text"].values():
                    assert st["docs"] >= 0
                time.sleep(0.003)
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)

    readers = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    writers = [threading.Thread(target=writer, args=(s,)) for s in range(2)]
    others = readers + [threading.Thread(target=poller)]
    [t.start() for t in writers + others]
    [t.join(timeout=120) for t in writers]
    stop.set()
    [t.join(timeout=30) for t in others]
    assert not any(t.is_alive() for t in writers + others)
    e.close()
    assert not errors, errors[:3]
    assert writes == [WRITES, WRITES] and min(reads) >= 1, (reads, writes)
    assert deleted_at


def test_decayed_searches_beside_reinforce(monkeypatch):
    """Two threads of decayed searches while a third reinforces their top
    hits, ROUNDS rounds at one fixed clock reading: the first search of a
    round refreshes the device decay mirror in place while the other
    thread searches; each search with the writer idle gives the host
    path's hits (`_assemble_fused`) on the same scan output."""
    from kektordb_tpu_torch.ops import fuse
    now = 1.7e9
    monkeypatch.setattr(time, "time", lambda: now)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    e.create_index("mem", m=8, ef_construction=64)
    e.add_batch("mem", [f"m{i}" for i in range(ROWS)], X, [
        {"_created_at": now - float(a), **({"_memory_layer": "episodic"}
                                           if i % 3 == 0 else {})}
        for i, a in enumerate(rng.uniform(0, 30 * 86400.0, ROWS))])
    e.configure_index("mem", {"memory": {
        "enabled": True, "decay_half_life": 86400.0,
        "layers": {"episodic": {"decay_half_life": 3600.0,
                                "decay_model": "ebbinghaus"}}}})
    qs = (X[:32] + 0.1, X[32:64] + 0.1)
    tops = [e.search("mem", q, k=5) for q in qs]
    h = e.indexes["mem"]
    start, done = (threading.Barrier(3, timeout=60) for _ in range(2))
    errors: list[Exception] = []
    held = [0, 0]

    def as_host(q, res):
        """Scores within 1e-5 of the host path's, ids equal wherever the
        host's adjacent scores differ by more (its 6 hits show a tie
        across the 5th place)."""
        with e._lock.read():
            d, rows, _ = h.index.search_device(q, 10)
            host = e._assemble_fused(
                h, h.index, d.numpy(), rows.numpy().astype(np.int64),
                len(q), 6, text_rows=np.empty(0, np.int64),
                text_vals=np.empty(0, np.float64), alpha=0.5, decay=True,
                include_metadata=False, columnar=True, now=now)
        for b, hits in enumerate(res):
            hs = np.array(host["scores"][b])
            np.testing.assert_allclose([x["score"] for x in hits], hs[:5],
                                       atol=1e-5)
            gap = np.abs(np.diff(hs))
            sep = np.minimum(np.r_[np.inf, gap], np.r_[gap, np.inf])[:5] \
                > 1e-5
            ids = np.array([x["id"] for x in hits])
            assert (ids[sep] == np.array(host["ids"][b][:5])[sep]).all()
        return len(res)

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as exc:   # noqa: BLE001
                errors.append(exc)
                start.abort()
                done.abort()
        return run

    def searcher(t):
        for _ in range(ROUNDS):
            start.wait()
            res = e.search("mem", qs[t], k=5)       # beside the reinforces
            assert all(len(x) == 5 for x in res)
            done.wait()
            tops[t] = e.search("mem", qs[t], k=5)   # writer idle
            held[t] += as_host(qs[t], tops[t])

    def reinforcer():
        for r in range(ROUNDS):
            start.wait()
            for hits in tops[r % 2][:16]:
                e.reinforce("mem", hits[0]["id"])
            done.wait()

    fuse.build_decay_device.calls = fuse.update_decay_device.calls = 0
    ts = [threading.Thread(target=guarded(f)) for f in
          (lambda: searcher(0), lambda: searcher(1), reinforcer)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors[:3]
    assert held == [ROUNDS * 32] * 2
    assert fuse.build_decay_device.calls == 0
    assert fuse.update_decay_device.calls == ROUNDS


def test_host_arena_first_searches_in_threads():
    """Four threads make a host index's first searches at once: the
    projected mirror ("auto", the arena past one chunk) is fitted once,
    and every thread gets the serial search's rows."""
    from kektordb_tpu_torch.ops import quantize as quant
    rng = np.random.default_rng(6)
    X = rng.normal(size=(4096, 64)).astype(np.float32)
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    e.create_index("h", kind="host")
    e.add_batch("h", [f"h{i}" for i in range(4096)], X)
    idx = e.indexes["h"].index
    idx.chunk_rows = 1024                      # 4 chunks: "auto" fits
    fits = []
    real = quant.fit_pca_basis

    def counted_fit(*a, **kw):
        fits.append(threading.get_ident())
        return real(*a, **kw)
    quant.fit_pca_basis = counted_fit
    try:
        Q = X[:64] + 0.05
        gate = threading.Barrier(4, timeout=60)
        got: list = [None] * 4
        errors: list[Exception] = []

        def first(t):
            try:
                gate.wait()
                got[t] = [[x["id"] for x in hits]
                          for hits in e.search("h", Q, k=5)]
            except Exception as exc:   # noqa: BLE001
                errors.append(exc)
        ts = [threading.Thread(target=first, args=(t,)) for t in range(4)]
        [t.start() for t in ts]
        [t.join(timeout=120) for t in ts]
        assert not any(t.is_alive() for t in ts)
    finally:
        quant.fit_pca_basis = real
    assert not errors, errors[:3]
    assert len(fits) == 1 and idx._proj_basis is not None
    serial = [[x["id"] for x in hits] for hits in e.search("h", Q, k=5)]
    assert got == [serial] * 4
