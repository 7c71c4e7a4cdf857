"""The graph beam's blocks (`hnsw_kernels._Loop`): the level-0 loop
run CHECK_EVERY iterations at a time on buffers of its own, the history
ring written at columns read from a device table by a device counter,
and on a CUDA device a cache entry's blocks replayed from a captured CUDA
graph.

On the CPU (the blocks run uncaptured there):
* a loop reloaded for a second call with other inputs, as a cache
  entry's is, gives a fresh loop's bits: distances, rows, iterations,
  done checks, ids scored and the loop's final state, single and dual,
  at expand 4 and at expand 3, where the ring's clamped start engages;
* the cache's rules as host logic: a key gets an entry the second time
  it is seen, a busy entry is handed to no one else (also under a storm
  of threads), at most `size` entries and `seen` keys are kept, least
  recently used out; the key follows the state's addresses, so a grown
  state has a key of its own;
* the counters: every CPU block is an eager one.

On a card (`card` marker; skipped without one), on a 30,000-row graph at
M 16, ef_construction 200: the replayed blocks against the uncaptured
loop (a key's first call on a cache of its own) bit for bit at the serving shape, dual with `allow` and `exclude`, at the
build's shape, over an int8 arena, after an in-place write to the
adjacency, after
`grow_state`, and from two threads (a caller that finds the block busy
runs uncaptured); the gather-distance launches counted alike.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from kektordb_tpu_torch import tracing
from kektordb_tpu_torch.index import HNSWConfig, HNSWIndex
from kektordb_tpu_torch.index import hnsw_kernels as K
from kektordb_tpu_torch.ops import distance as dist

L2 = "euclidean"


def counts() -> dict:
    c = tracing.counters()
    return {n: c.get(f"beam.{n}", 0)
            for n in ("graph_replays", "graph_captures", "eager_blocks")}


def moved(before: dict) -> dict:
    now = counts()
    return {n: now[n] - before[n] for n in now}


def search(state, q, qn, *, ef, expand, allow=None, exclude=None,
           dual=False, stats=True):
    """One `_beam_search` call: (d, rows, iterations, done checks, ids
    scored)."""
    s = K.BeamStats() if stats else None
    d, rows = K._beam_search(state, q, qn, L2, ef, expand, allow, exclude,
                             dual, None, s)
    if s is None:
        return d, rows
    return d, rows, s.iterations, s.done_checks, int(s.scored)


def uncaptured(state, q, qn, **kw):
    """The uncaptured loop's answer: a key's first call, on a cache of
    its own."""
    saved, K._GRAPHS = K._GRAPHS, K._GraphCache()
    try:
        return search(state, q, qn, **kw)
    finally:
        K._GRAPHS = saved


def assert_same(a, b):
    """Bit for bit: distances by their bits, the rest exactly."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])
    assert a[2:] == b[2:]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_graph():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(3000, 32)).astype(np.float32)
    idx = HNSWIndex(32, L2, "float32",
                    HNSWConfig(m=8, ef_construction=64, ef_search=64,
                               chunk=256, serve_mode="beam"), device="cpu")
    idx.add_batch([f"v{i}" for i in range(len(X))], X)
    q = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    yield idx.state, q, (q * q).sum(1), rng
    torch.set_num_threads(old)


@pytest.mark.parametrize("expand, ef, dual", [
    (4, 32, False), (3, 128, False), (4, 32, True), (3, 128, True)])
def test_blocks_give_the_eager_loops_bits(cpu_graph, expand, ef, dual,
                                         monkeypatch):
    state, q, qn, rng = cpu_graph
    kw = dict(ef=ef, expand=expand, dual=dual)
    if dual:
        kw["allow"] = torch.from_numpy(
            rng.random(state.vectors.shape[0]) < 0.6)
        kw["exclude"] = torch.arange(q.shape[0], dtype=torch.int32)
    loops, drive = [], K._drive

    def recording(loop, max_iters, capture):
        loops.append(loop)
        return drive(loop, max_iters, capture)

    monkeypatch.setattr(K, "_drive", recording)
    before = counts()
    q2 = q.flip(0) + 0.5
    other = search(state, q2, (q2 * q2).sum(1), **kw)
    fresh = search(state, q, qn, **kw)
    # the first call's loop, reloaded with this call's inputs, as a cache
    # entry's loop is for its key's next call
    monkeypatch.setattr(K, "_Loop", lambda: loops[0])
    reloaded = search(state, q, qn, **kw)
    assert loops[2] is loops[0] and loops[1] is not loops[0]
    assert not torch.equal(other[1], fresh[1])
    assert_same(reloaded, fresh)
    # the whole loop state at the end, the history ring's order included
    for name in ("hist", "done", "scored", "cand_x", "cand_i", "res_i"):
        assert torch.equal(getattr(loops[1], name), getattr(loops[2], name))
    it, max_iters = fresh[2], (2 * ef) // expand + 24
    assert fresh[3] == (it if it < max_iters else it - 1) // K.CHECK_EVERY
    # every CPU block runs uncaptured, in the three calls
    blocks = -(-other[2] // K.CHECK_EVERY) + 2 * -(-it // K.CHECK_EVERY)
    assert moved(before) == {"graph_replays": 0, "graph_captures": 0,
                             "eager_blocks": blocks}
    if expand == 3:
        # the ring is 128 wide: iteration 42's 3 ids would start at 126
        # and run past it, so the start is clamped to 125
        R = min(K._next_pow2(max_iters * expand), 128)
        cols = K._hist_cols(max_iters, 3, R, "cpu")
        assert R == 128 and cols[42].tolist() == [125, 126, 127]
        assert it > 42


def test_cpu_calls_take_no_entry(cpu_graph, monkeypatch):
    state, q, qn, _ = cpu_graph
    cache = K._GraphCache()
    monkeypatch.setattr(K, "_GRAPHS", cache)
    for _ in range(3):
        search(state, q, qn, ef=32, expand=4)
    assert not cache._entries and not cache._seen


class Entry:
    busy = False


def test_a_key_gets_an_entry_the_second_time():
    cache = K._GraphCache(make=Entry)
    assert cache.acquire("a") is None            # first sight: eager
    e = cache.acquire("a")
    assert isinstance(e, Entry) and e.busy
    assert cache.acquire("a") is None            # busy: eager
    cache.release(e)
    assert cache.acquire("a") is e
    cache.release(e)
    assert cache.acquire("b") is None


def test_the_entries_and_the_seen_keys_are_bounded():
    cache = K._GraphCache(size=2, seen=2, make=Entry)
    entries = {}
    for k in "abc":
        cache.acquire(k)
        entries[k] = cache.acquire(k)
        cache.release(entries[k])
    # "a" was used least recently: it went, and counts as new again
    assert list(cache._entries) == ["b", "c"]
    assert cache.acquire("a") is None
    e = cache.acquire("b")
    assert e is entries["b"]
    cache.release(e)
    # the seen keys: "a", then "x", "y" push "a" out
    cache.acquire("x")
    cache.acquire("y")
    assert list(cache._seen) == ["x", "y"]
    assert cache.acquire("a") is None


def test_no_entry_has_two_holders_under_a_thread_storm():
    """16 threads, more than the cores, a short switch interval: each
    acquires one of three keys, and an entry it gets must have no other
    holder until it is released."""
    cache = K._GraphCache(size=2, seen=2, make=Entry)
    holders, clashes, got = {}, [], [0]
    lock = threading.Lock()

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(400):
            e = cache.acquire(int(rng.integers(0, 3)))
            if e is None:
                continue
            with lock:
                if id(e) in holders:
                    clashes.append(e)
                holders[id(e)] = seed
                got[0] += 1
            time.sleep(0)
            with lock:
                del holders[id(e)]
            cache.release(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not clashes and got[0] > 0
    assert not any(e.busy for e in cache._entries.values())


def test_the_key_follows_the_state_and_the_call(cpu_graph):
    state, q, qn, _ = cpu_graph

    def key(st=state, qq=q, ef=32, E=4, allow=None, exclude=None,
            dual=False, stats=None):
        return K._graph_key(st, qq, qn, L2, ef, E, allow, exclude, dual,
                            stats)

    assert key() == key(qq=q + 1.0)              # other queries, one shape
    grown = K.grow_state(state, state.vectors.shape[0] + 256,
                         state.up_node.shape[0])
    others = [key(st=grown), key(qq=q[:32]), key(ef=48), key(E=8),
              key(dual=True),
              key(exclude=torch.zeros(64, dtype=torch.int32)),
              key(exclude=torch.zeros(64, dtype=torch.int64)),
              key(allow=torch.ones(4, dtype=torch.bool)),
              key(stats=K.BeamStats()), key(qq=q.to(torch.bfloat16))]
    assert len({key(), *others}) == 1 + len(others)


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

N, D = 30000, 128


@pytest.fixture(scope="module")
def card_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blocks are captured only there")
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(64, D)).astype(np.float32) * 4
    X = centers[rng.integers(0, 64, N)] + rng.normal(size=(N, D)).astype(
        np.float32)
    idx = HNSWIndex(D, L2, "float32", HNSWConfig(serve_mode="beam"),
                    device="cuda")
    idx.add_batch([f"v{i}" for i in range(N)], X)
    idx.flush()

    def queries(b, seed):
        r = np.random.default_rng(seed)
        qq = X[r.integers(0, N, b)] + r.normal(size=(b, D)).astype(
            np.float32) * 0.5
        t = torch.from_numpy(qq).cuda()
        return t, (t * t).sum(1)

    return idx, queries


@pytest.fixture
def cache(monkeypatch):
    c = K._GraphCache()
    monkeypatch.setattr(K, "_GRAPHS", c)
    return c


def three_calls(state, q, qn, **kw):
    """The uncaptured loop, then a key's first call (uncaptured), its
    second (the capture and replays) and its third (replays): the
    counters each moved and the gather-distance launches each counted."""
    out = []
    for call in (uncaptured, search, search, search):
        before, launches = counts(), dist.gathered.launches
        r = call(state, q, qn, **kw)
        torch.cuda.synchronize()
        out.append((r, moved(before), dist.gathered.launches - launches))
    return out


@pytest.mark.card
@pytest.mark.parametrize("shape", ["serve", "dual", "build", "int8"])
def test_replays_give_the_eager_loops_bits(card_graph, cache, shape):
    idx, queries = card_graph
    state = idx.state
    kw = {"serve": dict(ef=100, expand=4),
          "dual": dict(ef=100, expand=4, dual=True),
          "build": dict(ef=200, expand=8, stats=False),
          "int8": dict(ef=100, expand=4)}[shape]
    q, qn = queries(512 if shape == "build" else 1024, 1)
    if shape == "int8":
        # a compressed arena's read: float queries over int8 codes, L2
        # scored by torch ops (no gather-distance kernel)
        scale = float(state.vectors.abs().max()) / 127.0
        codes = torch.clamp(torch.round(state.vectors / scale), -127,
                            127).to(torch.int8)
        state = state._replace(vectors=codes,
                               norms=codes.float().norm(dim=1))
        q = q / scale
    if shape == "dual":
        rng = np.random.default_rng(3)
        kw["allow"] = torch.from_numpy(
            rng.random(state.vectors.shape[0]) < 0.7).cuda()
        kw["exclude"] = torch.from_numpy(
            rng.integers(0, N, q.shape[0]).astype(np.int32)).cuda()
    (eager, m0, l0), (first, m1, l1), (second, m2, l2), (third, m3, l3) = \
        three_calls(state, q, qn, **kw)
    for r in (first, second, third):
        assert_same(r, eager)
    # the build passes no stats: its blocks are the first call's
    blocks = m1["eager_blocks"]
    assert m1 == {"graph_replays": 0, "graph_captures": 0,
                  "eager_blocks": blocks} and blocks > 1
    assert m2["graph_captures"] == 1 and m3["graph_captures"] == 0
    for m in (m2, m3):
        assert m["graph_replays"] + m["eager_blocks"] == blocks
        assert m["eager_blocks"] <= 1                # a tail at most
        if shape != "build":
            assert m["graph_replays"] == eager[2] // K.CHECK_EVERY
    assert len(cache._entries) == 1
    assert l0 == l1 == l2 == l3


@pytest.mark.card
def test_a_replay_sees_an_in_place_write(card_graph, cache):
    idx, queries = card_graph
    state = idx.state
    q, qn = queries(1024, 2)
    kw = dict(ef=100, expand=4)
    for _ in range(2):
        search(state, q, qn, **kw)                  # seen, then captured
    saved = state.nbrs.clone()
    try:
        # drop the last half of every row's links, in place
        state.nbrs[:, state.nbrs.shape[1] // 2:] = -1
        before = counts()
        replayed = search(state, q, qn, **kw)
        assert moved(before)["graph_replays"] > 0
        eager = uncaptured(state, q, qn, **kw)
        assert_same(replayed, eager)
    finally:
        state.nbrs.copy_(saved)
    assert not torch.equal(eager[1], search(state, q, qn, **kw)[1])


@pytest.mark.card
def test_a_grown_state_is_captured_anew(card_graph, cache):
    idx, queries = card_graph
    q, qn = queries(1024, 4)
    kw = dict(ef=100, expand=4)
    for _ in range(2):
        search(idx.state, q, qn, **kw)
    grown = K.grow_state(idx.state, idx.state.vectors.shape[0] + 4096,
                         idx.state.up_node.shape[0])
    # the grown adjacency differs from the old one
    grown.nbrs[:, grown.nbrs.shape[1] // 2:] = -1
    eager = uncaptured(grown, q, qn, **kw)
    before = counts()
    first = search(grown, q, qn, **kw)
    assert moved(before)["graph_replays"] == 0       # a new key
    second = search(grown, q, qn, **kw)
    assert moved(before)["graph_captures"] == 1
    assert_same(first, eager)
    assert_same(second, eager)
    assert len(cache._entries) == 2


@pytest.mark.card
def test_a_busy_block_runs_eagerly_in_another_thread(card_graph, cache):
    idx, queries = card_graph
    state = idx.state
    kw = dict(ef=100, expand=4)
    sets = [queries(1024, 10 + i) for i in range(4)]
    eager = [uncaptured(state, q, qn, **kw) for q, qn in sets]
    for _ in range(2):
        search(state, *sets[0], **kw)
    key, = cache._entries
    held = cache.acquire(key)
    assert held is not None
    out, before = {}, counts()
    t = threading.Thread(target=lambda: out.update(
        r=search(state, *sets[1], **kw), m=moved(before)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    cache.release(held)
    assert_same(out["r"], eager[1])
    assert out["m"]["graph_replays"] == 0 and out["m"]["eager_blocks"] > 0

    # four threads at once, three calls each: each answer is its own
    # query set's, whether it replayed or ran eagerly
    results = {i: [] for i in range(4)}
    barrier = threading.Barrier(4)

    def client(i):
        barrier.wait()
        for _ in range(3):
            results[i].append(search(state, *sets[i], **kw))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    for i in range(4):
        assert len(results[i]) == 3
        for r in results[i]:
            assert_same(r, eager[i])
