"""The port's graph read against a textbook HNSW search over the same
graph, at upstream KektorDB's SIFT-1M settings (M 16, ef_construction
200, ef_search 100) on 6,000 SIFT-like rows and 200 queries.

* The port's beam recall@10 against the exact top 10 is at least the
  textbook search's (`h100_bench/reference/hnsw_search.py`: Malkov &
  Yashunin's Alg. 5 with Alg. 2, float64) less 0.01. The port's beam is
  a lockstep batch beam (4 expansions a step, duplicates dropped by the
  pools and a 128-id history ring in place of a visited set, done when
  its best unexpanded candidate is no nearer than its ef-th result), so
  its path differs from Alg. 2's one expansion at a time; 0.01 is the
  margin the port's build is held to against the JAX package's
  (tests/test_torch_graph.py).
* Every hit's distance is its float64 squared distance within
  2e-6 (|q|^2 + |x|^2): float32 evaluates |q|^2 - 2 q.x + |x|^2, whose
  terms are of that size, to a few of their ulps (about 6e-8 each); a
  bfloat16 row would be off by about 1e-3.
* The graph's invariants: level-0 rows of 2 M slots, no self-edge or
  repeated neighbour, and every live row reachable from the entry at
  level 0 (the build links each row no walk from the entry reaches).
* The textbook search is exact on a hand-built path graph.
* The beam's counters: `beam.done_checks` is what the loop's own rule
  gives for the iterations it ran (a test every CHECK_EVERY-th
  iteration after the first), so no synchronisation has crept in; the
  graph's spans and counters reach `/metrics`.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kektordb_tpu_torch import tracing
from kektordb_tpu_torch.index import HNSWConfig, HNSWIndex
from kektordb_tpu_torch.index import hnsw_kernels as K

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
N, NQ, K_NN = 6000, 200, 10
CFG = HNSWConfig(serve_mode="beam")            # m 16, efC 200, efS 100
RECALL_MARGIN = 0.01
DIST_RTOL = 2e-6


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


textbook = _load("reference/hnsw_search.py", "bench_hnsw_search")
sift_like = _load("data/sift_like.py", "bench_sift_like")


@pytest.fixture(scope="module")
def built():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        ds = sift_like.make({"dataset": {"rows": N, "dim": 128,
                                         "queries": NQ,
                                         "metric": "euclidean"}},
                            2**33 + 19, torch.device("cpu"))
        X, Q = ds["rows"].numpy(), ds["queries"].numpy()
        idx = HNSWIndex(128, config=CFG, device="cpu")
        idx.add_batch([str(i) for i in range(N)], X)
        d, rows = idx.search(Q, K_NN)
        yield SimpleNamespace(X=X, Q=Q, idx=idx, d=d, rows=rows)
    finally:
        torch.set_num_threads(old)


def _exact(X, Q):
    d64 = ((Q[:, None, :].astype(np.float64)
            - X[None].astype(np.float64)) ** 2).sum(-1)
    return d64, np.sort(d64, 1)[:, K_NN - 1]


def _recall(d64, kth, rows):
    got = np.take_along_axis(d64, np.maximum(rows, 0).astype(np.int64), 1)
    return float(((rows >= 0) & (got <= kth[:, None] * (1 + 1e-9))).mean())


def test_beam_recall_is_the_textbook_search_s(built):
    d64, kth = _exact(built.X, built.Q)
    ref_rows, ref_d = textbook.search(built.idx.state, built.Q, K_NN,
                                      CFG.ef_search, "euclidean")
    np.testing.assert_allclose(
        ref_d, np.take_along_axis(d64, ref_rows, 1), rtol=1e-12)
    port, ref = _recall(d64, kth, built.rows), _recall(d64, kth, ref_rows)
    assert port >= ref - RECALL_MARGIN, (port, ref)
    assert ref > 0.9


def test_every_hit_distance_is_float64_s(built):
    d64, _ = _exact(built.X, built.Q)
    rows = built.rows.astype(np.int64)
    assert (rows >= 0).all()
    exact = np.take_along_axis(d64, rows, 1)
    scale = (built.Q.astype(np.float64) ** 2).sum(1)[:, None] \
        + (built.X[rows].astype(np.float64) ** 2).sum(-1)
    assert np.all(np.abs(built.d - exact) <= DIST_RTOL * scale)
    assert np.all(np.diff(built.d, axis=1) >= 0)


def test_graph_invariants(built):
    st = built.idx.state
    nb = st.nbrs[:N].numpy()
    assert nb.shape[1] == 2 * CFG.m
    assert (nb < N).all()
    assert not (nb == np.arange(N)[:, None]).any()
    pad = -1 - np.arange(nb.shape[1])[None, :]
    srt = np.sort(np.where(nb >= 0, nb, pad), 1)
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    live = (st.levels[:N].numpy() >= 0) & ~st.deleted[:N].numpy()
    seen = np.zeros(N, bool)
    front = np.array([int(st.entry)])
    seen[front] = True
    while front.size:
        nxt = nb[front].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        front = nxt[~seen[nxt]]
        seen[front] = True
    assert np.array_equal(seen, live), np.nonzero(live & ~seen)[0]


def _path_graph(n: int, step: int):
    """Points 0..n-1 on a line, each linked to its two neighbours at
    level 0; every `step`-th point also at level 1, linked to the
    level's two neighbours there."""
    upper = list(range(0, n, step))
    up_of = np.full(n, -1, np.int32)
    up_of[upper] = np.arange(len(upper))
    up_nbrs = np.full((len(upper), 1, 2), -1, np.int32)
    for u, node in enumerate(upper):
        up_nbrs[u, 0] = [node - step if node >= step else -1,
                         node + step if node + step < n else -1]
    nbrs = np.array([[i - 1 if i else -1, i + 1 if i + 1 < n else -1]
                     for i in range(n)], np.int32)
    vectors = np.stack([np.arange(n), np.zeros(n)], 1).astype(np.float32)
    return SimpleNamespace(
        entry=torch.tensor(upper[-1]), max_level=torch.tensor(1),
        vectors=torch.from_numpy(vectors), nbrs=torch.from_numpy(nbrs),
        up_of=torch.from_numpy(up_of), up_nbrs=torch.from_numpy(up_nbrs))


@pytest.mark.parametrize("k,ef", [(1, 1), (5, 5), (7, 20)])
def test_textbook_search_is_exact_on_a_path_graph(k, ef):
    n = 200
    g = _path_graph(n, 10)
    rng = np.random.default_rng(3)
    Q = np.stack([rng.uniform(-5, n + 5, 64), rng.normal(size=64)], 1)
    rows, d = textbook.search(g, Q, k, ef, "euclidean")
    x = g.vectors.numpy().astype(np.float64)
    exact = ((Q[:, None, :] - x[None]) ** 2).sum(-1)
    want = np.argsort(exact, 1, kind="stable")[:, :k]
    np.testing.assert_array_equal(rows, want)
    np.testing.assert_allclose(d, np.take_along_axis(exact, want, 1))


def _checks_by_rule(iterations: int, max_iters: int) -> int:
    """The loop tests whether every query is done at each iteration
    it > 0 with it % CHECK_EVERY == 0 that it reached: the last one too
    where it stopped early."""
    last = iterations + 1 if iterations < max_iters else iterations
    return sum(1 for it in range(1, last) if it % K.CHECK_EVERY == 0)


@pytest.mark.parametrize("nq,ef", [(200, 100), (37, 10), (5, 300)])
def test_done_checks_follow_the_loops_rule(built, nq, ef):
    before = tracing.counters()
    built.idx.search(built.Q[:nq], K_NN, ef=ef)
    after = tracing.counters()
    got = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("beam.searches", "beam.iterations", "beam.done_checks",
                     "beam.scored")}
    E = min(CFG.serve_expand, ef)
    max_iters = (2 * ef) // E + 24
    assert got["beam.searches"] == 1
    assert 1 <= got["beam.iterations"] <= max_iters
    assert got["beam.done_checks"] == _checks_by_rule(
        got["beam.iterations"], max_iters)
    C = E * 2 * CFG.m
    assert 0 < got["beam.scored"] <= got["beam.iterations"] * nq * C


def test_the_graph_spans_and_counters_reach_metrics(built):
    from kektordb_tpu_torch.server.metrics import span_lines
    built.idx.search(built.Q[:3], K_NN)
    text = "\n".join(span_lines())
    for name in ("index.descend", "index.beam", "graph.link",
                 "graph.select", "graph.upper"):
        assert f'kektordb_span_seconds_sum{{name="{name}"}}' in text, name
    for name in ("beam.searches", "beam.iterations", "beam.done_checks",
                 "beam.scored", "graph.linked_rows"):
        series = "kektordb_" + name.replace(".", "_") + "_total"
        assert f"\n{series} " in text, name


def test_a_lost_row_is_adopted_without_losing_another():
    """Row 3 has no in-link; its nearest out-neighbour, row 0, is full:
    3 takes the place of 0's farthest entry that keeps another in-link
    (row 2, also linked from 1), not of row 4 (linked from 0 alone).
    Rows 5 and 6 link only each other and out to 1: 5 joins 1's free
    slot, and 6 then takes the place of 1's entry that keeps another
    in-link (row 0, linked from 2, 3 and 4)."""
    x = torch.tensor([[0.0], [1.0], [2.0], [0.5], [9.0], [1.2], [1.4]])
    st = K.init_state(7, 1, torch.float32, m0=3, lmax=1, mu=2, ucap=4,
                      device="cpu")
    st.vectors.copy_(x)
    st.norms.copy_((x ** 2).sum(1))
    st.nbrs.copy_(torch.tensor([[1, 2, 4], [0, 2, -1], [1, 0, -1],
                                [0, 1, -1], [0, -1, -1], [6, 1, -1],
                                [5, 1, -1]]))
    st.levels.fill_(0)
    st.entry.fill_(0)
    st.size.fill_(7)
    assert int((~K.reached(st, 7)).sum()) == 3
    assert K.adopt_unreachable(st, torch.ones(7, dtype=torch.bool),
                               "euclidean") == 3
    assert st.nbrs[0].tolist() == [1, 3, 4]
    assert st.nbrs[1].tolist() == [6, 2, 5]
    assert bool(K.reached(st, 7).all())
