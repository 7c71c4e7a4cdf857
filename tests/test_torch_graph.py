"""The port's graph build and beam serving against the JAX package.

* On one JAX-built graph state carried across (some rows soft-deleted),
  each graph function gets the same inputs on both sides: `descend`,
  `beam_search` (single pool; dual with an allow mask and the deleted
  rows), `select_neighbors`, `commit_chunk`, `update_upper`,
  `refine_chunk` and `rows_referencing_deleted`. Rows must be equal on at
  least 99% of entries (float32 sums in another order can swap near-ties
  and so change a later step), distances within rtol 1e-5 where the rows
  agree, with an absolute floor of 1e-4 for cancellation near zero.
* A graph built by the port keeps the invariants (degree <= M0, no
  self-links, up_of / up_node inverse) and its beam recall@10 against the
  exact oracle is within 0.01 of the JAX package's build of the same data.
* The beam loop asks the device whether it is done only every few
  iterations; the extra iterations change no result.
* `from_reference_state` carries the graph's host mirrors, so later
  upper-level inserts take the reference's slots.
* The default Engine index (serve_mode "auto") runs every entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kektordb_tpu.index import HNSWConfig as JConfig
from kektordb_tpu.index import HNSWIndex as JIndex
from kektordb_tpu.index import hnsw_kernels as JK
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index import HNSWConfig, HNSWIndex
from kektordb_tpu_torch.index import hnsw_kernels as K
from kektordb_tpu_torch.ops import distance as dist

RTOL = 1e-5
MATCH = 0.99
N, D, M, EFC = 2500, 32, 8, 64


def _cfg(cls, **kw):
    return cls(m=M, ef_construction=EFC, ef_search=EFC, chunk=256, **kw)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def data(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def to_port(jstate) -> K.GraphState:
    """A fresh torch copy of a JAX GraphState."""
    host = jax.device_get(jstate)
    return K.GraphState(**{f: torch.from_numpy(np.array(getattr(host, f)))
                           for f in K.GraphState._fields})


def jcopy(jstate):
    """A copy the jitted reference functions may donate."""
    return jax.tree.map(jnp.copy, jstate)


def same_rows(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean(a == b))


def changed_rows(before, ref_after, port_after):
    """Rows either call wrote, and of them the entries that hold a link on
    either side: the entries a parity check should count."""
    flat = [np.asarray(a).reshape(len(before), -1)
            for a in (before, ref_after, port_after)]
    b, r, p = flat
    rows = np.any(r != b, 1) | np.any(p != b, 1)
    return rows, (r[rows] >= 0) | (p[rows] >= 0)


def assert_pools(jd, ji, td, ti):
    jd, ji, td, ti = map(np.asarray, (jd, ji, td, ti))
    assert same_rows(ji, ti) >= MATCH
    eq = (ji == ti) & (ji >= 0)
    np.testing.assert_allclose(td[eq], jd[eq], rtol=RTOL, atol=1e-4)


@pytest.fixture(scope="module")
def built():
    """A JAX-built graph with 5% of its rows soft-deleted."""
    X = data(N + 200, D, 0)
    ref = JIndex(D, "euclidean", "float32", config=_cfg(JConfig))
    ref.add_batch([f"v{i}" for i in range(N)], X[:N])
    for i in range(0, N, 20):
        ref.delete(f"v{i}")
    return ref, X


def test_descend_and_beam_same_rows(built):
    ref, X = built
    st = ref.state
    Q = data(64, D, 1)
    jq, tq = jnp.asarray(Q), torch.from_numpy(Q)
    jn, tn = jnp.sum(jq ** 2, -1), torch.sum(tq ** 2, -1)
    ts = to_port(st)
    assert same_rows(JK.descend(st, jq, jn, "euclidean"),
                     K.descend(ts, tq, tn, "euclidean")) >= MATCH
    jd, ji = JK.beam_search(st, jq, jn, metric="euclidean", ef=32, expand=4)
    td, ti = K.beam_search(ts, tq, tn, metric="euclidean", ef=32, expand=4)
    assert_pools(jd, ji, td, ti)
    allow = np.zeros(ref._cap, bool)
    allow[1:N:3] = True
    jd, ji = JK.beam_search(st, jq, jn, metric="euclidean", ef=32, expand=4,
                            allow=jnp.asarray(allow), dual=True)
    td, ti = K.beam_search(ts, tq, tn, metric="euclidean", ef=32, expand=4,
                           allow=torch.from_numpy(allow), dual=True)
    assert_pools(jd, ji, td, ti)
    got = ti.numpy()
    assert np.all(allow[got[got >= 0]])
    assert not np.any(np.isin(got, np.arange(0, N, 20)))


def test_beam_extra_iterations_change_nothing(built, monkeypatch):
    """Checking `done` every iteration, or never before max_iters, gives
    the same pools: a finished query's iteration merges only +inf / -1."""
    ref, _ = built
    ts = to_port(ref.state)
    Q = torch.from_numpy(data(32, D, 2))
    qn = torch.sum(Q ** 2, -1)
    outs = []
    for every in (1, 10 ** 6):
        monkeypatch.setattr(K, "CHECK_EVERY", every)
        outs.append(K.beam_search(ts, Q, qn, metric="euclidean", ef=24,
                                  expand=4, dual=True))
    (d1, i1), (d2, i2) = outs
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_select_commit_update_refine_same_rows(built):
    ref, X = built
    st = jcopy(ref.state)
    ts = to_port(st)
    C = 64
    rows = np.full((C,), -1, np.int32)
    rows[:48] = np.arange(N, N + 48)
    enc = np.zeros((C, D), np.float32)
    enc[:48] = X[N:N + 48]
    norms = (enc ** 2).sum(-1)
    levels = np.full((C,), -1, np.int32)
    levels[:48] = 0
    levels[:3] = [1, 2, 1]
    jr, je, jnm, jl = map(jnp.asarray, (rows, enc, norms, levels))
    tr, te, tnm, tl = map(torch.from_numpy, (rows, enc, norms, levels))

    # candidates from the reference's beam feed both select_neighbors
    st = JK.write_vectors(st, jr, je, jnm)
    K.write_vectors(ts, tr, te, tnm)
    cd, ci = JK.beam_search(st, je, jnm, metric="euclidean", ef=EFC,
                            expand=8, dual=True)
    ji, jd = JK.select_neighbors(st, cd, ci, M, "euclidean")
    ti, td = K.select_neighbors(ts, torch.from_numpy(np.array(cd)),
                                torch.from_numpy(np.array(ci)), M,
                                "euclidean")
    assert_pools(jd, ji, td, ti)

    # the same selection commits on both sides; counted over the rows
    # either side wrote (the chunk's and its reverse links' targets)
    before = ts.nbrs.numpy().copy()
    st = JK.commit_chunk(st, jr, ji, jd, jl, metric="euclidean", m=M)
    K.commit_chunk(ts, tr, torch.from_numpy(np.array(ji)),
                   torch.from_numpy(np.array(jd)), tl, metric="euclidean",
                   m=M)
    jn, tn = np.asarray(st.nbrs), ts.nbrs.numpy()
    rows_w, links = changed_rows(before, jn, tn)
    assert rows_w[N:N + 48].all() and rows_w.sum() > 48
    assert same_rows(jn[rows_w][links], tn[rows_w][links]) >= MATCH
    for f in ("levels", "entry", "max_level", "size"):
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      getattr(ts, f).numpy())

    # upper layers: the three new level >= 1 nodes take fresh slots
    slots = np.arange(ref._up_next, ref._up_next + 3, dtype=np.int32)
    un = np.full((4,), -1, np.int32)
    us = np.full((4,), -1, np.int32)
    un[:3], us[:3] = rows[:3], slots
    before = ts.up_nbrs.numpy().copy()
    st = JK.update_upper(st, jnp.asarray(un), jnp.asarray(us),
                         metric="euclidean")
    K.update_upper(ts, torch.from_numpy(un), torch.from_numpy(us),
                   metric="euclidean")
    for f in ("up_of", "up_node"):
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      getattr(ts, f).numpy())
    # counted over the upper rows either side wrote: the new nodes' slots
    # and the rows that took a reverse link
    jun, tun = np.asarray(st.up_nbrs), ts.up_nbrs.numpy()
    rows_w, links = changed_rows(before, jun, tun)
    assert rows_w[slots].all() and links.sum() > 0
    ju = np.asarray(st.up_dists).reshape(len(before), -1)[rows_w][links]
    tu = ts.up_dists.numpy().reshape(len(before), -1)[rows_w][links]
    ji_w = jun.reshape(len(before), -1)[rows_w][links]
    ti_w = tun.reshape(len(before), -1)[rows_w][links]
    assert same_rows(ji_w, ti_w) >= MATCH
    eq = ji_w == ti_w
    np.testing.assert_allclose(tu[eq], ju[eq], rtol=RTOL, atol=1e-4)

    # refine a batch of live rows (deleted ones among their neighbours)
    rr = np.arange(5, 69, dtype=np.int32)
    st = JK.refine_chunk(st, jnp.asarray(rr), metric="euclidean", ef=EFC,
                         m_out=2 * M)
    K.refine_chunk(ts, torch.from_numpy(rr), metric="euclidean", ef=EFC,
                   m_out=2 * M)
    assert same_rows(np.asarray(st.nbrs)[rr], ts.nbrs.numpy()[rr]) >= MATCH
    np.testing.assert_array_equal(
        np.asarray(JK.rows_referencing_deleted(st)),
        K.rows_referencing_deleted(ts).numpy())


def test_insert_chunk_same_graph():
    """`insert_chunk` on both sides from the empty graph: a first chunk
    (the beam finds nothing, the intra-chunk candidates seed the graph),
    then a second that the beam links into it. The adjacency, levels,
    entry point and size come out equal."""
    X = data(256, D, 6)
    C, cap = 128, 512
    kw = dict(m0=2 * M, lmax=4, mu=M, ucap=64)
    st = JK.init_state(cap, D, jnp.float32, **kw)
    ts = K.init_state(cap, D, torch.float32, device="cpu", **kw)
    levels = np.zeros(C, np.int32)
    levels[[5, 70]] = [1, 2]
    for c in range(2):
        rows = np.arange(c * C, (c + 1) * C, dtype=np.int32)
        enc = X[rows]
        norms = (enc ** 2).sum(-1)
        args = dict(metric="euclidean", ef=EFC, m=M, intra_k=16)
        st = JK.insert_chunk(st, *map(jnp.asarray, (rows, enc, norms,
                                                    levels)), **args)
        ts = K.insert_chunk(ts, *map(torch.from_numpy, (rows, enc, norms,
                                                        levels)), **args)
    assert (np.asarray(st.nbrs)[C:2 * C] >= 0).sum() > C * M
    for f in ("nbrs", "levels", "entry", "max_level", "size"):
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      getattr(ts, f).numpy())


def test_port_build_invariants_and_recall(built):
    """The port builds from the same data and seed; its graph keeps the
    invariants and its beam recall is within 0.01 of the reference's."""
    ref_full, X = built
    Q = data(100, D, 3)
    gt = dist.brute_force_topk(torch.from_numpy(Q), torch.from_numpy(X[:N]),
                               10)[1].numpy()

    def recall(rows):
        return np.mean([len(set(rows[b]) & set(gt[b])) / 10
                        for b in range(len(Q))])

    ref = JIndex(D, "euclidean", "float32", config=_cfg(JConfig))
    port = HNSWIndex(D, config=_cfg(HNSWConfig), device="cpu")
    for idx in (ref, port):
        idx.add_batch([f"v{i}" for i in range(N)], X[:N])
    r_ref = recall(np.asarray(ref.search(Q, 10, mode="beam")[1]))
    r_port = recall(port.search(Q, 10, mode="beam")[1])
    assert r_port >= r_ref - 0.01 and r_port > 0.9

    st = port.state
    nb = st.nbrs[:N]
    assert int((nb >= 0).sum(1).max()) <= 2 * M
    assert not bool((nb == torch.arange(N)[:, None]).any())
    assert int(nb.max()) < N
    up = st.up_node.numpy()
    occ = np.nonzero(up >= 0)[0]
    np.testing.assert_array_equal(st.up_of.numpy()[up[occ]], occ)
    assert int((st.up_of >= 0).sum()) == occ.size
    assert np.all(st.levels.numpy()[up[occ]] >= 1)
    np.testing.assert_array_equal(st.levels.numpy(),
                                  np.asarray(ref.state.levels))
    assert int(st.entry) == int(ref.state.entry)


def test_from_reference_state_carries_graph_mirrors():
    """A linked JAX index with an unlinked backlog carried across: the
    next upper slot, the backlog, the refine cursor and needs_refine come
    with it, so rows of level >= 1 added on both sides land in the same
    upper slots (without `up_next` the port would hand out slot 0 again
    and overwrite the reference's upper rows)."""
    X = data(2000, D, 4)
    ref = JIndex(D, "euclidean", "float32", config=_cfg(JConfig))
    ref.add_batch([f"v{i}" for i in range(1200)], X[:1200], fast=True)
    for i in range(1200, 1270):          # staged but not linked
        ref.add(f"v{i}", X[i])
    ref.settle_for_serving()
    assert ref._unlinked and ref._up_next > 0
    port = HNSWIndex.from_reference_state(
        jax.device_get(ref.state)._asdict(),
        {"row_to_ext": ref.ids.row_to_ext, "free": ref.ids.free},
        _cfg(HNSWConfig), metric="euclidean", precision="float32",
        device="cpu",
        mirrors={"max_level": ref._max_level, "up_free": ref._up_free,
                 "up_next": ref._up_next, "unlinked": ref._unlinked,
                 "refine_cursor": ref._refine_cursor,
                 "needs_refine": ref.needs_refine,
                 "rng_state": ref.rng.bit_generator.state})
    assert port._unlinked == ref._unlinked and port.needs_refine
    for idx in (ref, port):
        idx.add_batch([f"n{i}" for i in range(600)], X[1270:1870])
    np.testing.assert_array_equal(np.asarray(ref.state.up_node),
                                  port.state.up_node.numpy())
    np.testing.assert_array_equal(np.asarray(ref.state.up_of),
                                  port.state.up_of.numpy())
    assert port._up_next == ref._up_next and not port._unlinked


def test_default_engine_index_runs_every_entry_point():
    """Engine.create_index with every default (serve_mode "auto",
    ef_construction 200, ef_search 100), then add_batch / add / search /
    beam search / delete / run_maintenance / import_batch, on the CPU."""
    X = data(400, D, 5)
    eng = Engine(EngineConfig(device="cpu", start_background=False)).open()
    try:
        eng.create_index("x")
        eng.add_batch("x", [f"v{i}" for i in range(300)], X[:300])
        eng.add("x", "extra", X[300])
        hits = eng.search("x", X[:4], k=5)
        assert [h[0]["id"] for h in hits] == ["v0", "v1", "v2", "v3"]
        idx = eng.indexes["x"].index
        assert idx.config.serve_mode == "auto"
        assert idx.config.ef_construction == 200
        _, rows = idx.search(X[300:301], 1, mode="beam")
        assert rows[0, 0] == idx.ids.get("extra")
        assert int((idx.state.nbrs[:301] >= 0).sum(1).min()) > 0
        for i in range(0, 300, 5):
            eng.delete("x", f"v{i}")
        assert eng.run_maintenance() == {"x": "vacuum"}
        assert idx.deleted_count == 0
        assert eng.run_maintenance() == {"x": "refine"}
        _, rows = idx.search(X[:20], 3, mode="beam")
        assert not np.isin(rows, np.arange(0, 300, 5)).any()
        eng.create_index("imp", ef_search=50)
        eng.import_batch("imp", [f"w{i}" for i in range(100)], X[300:])
        imp = eng.indexes["imp"].index
        assert not imp.needs_refine and imp.config.ef_search == 50
        res = eng.search("imp", X[310], k=1, ef=64)
        assert res[0][0]["id"] == "w10"
        eng.create_index("b", serve_mode="beam")
        eng.add_batch("b", [f"b{i}" for i in range(100)], X[:100])
        assert eng.search("b", X[7], k=1)[0][0]["id"] == "b7"
        assert eng.indexes["b"].index.search_device(X[:1], 1) is None
    finally:
        eng.close()
