"""The port's host-RAM arena (kektordb_tpu_torch/index/hostarena.py) held
to the JAX package's, on the CPU.

The same seeded inputs (chunks of 1024-2048 rows, d 16-64, 3k-6k rows)
go into both. A full-dimension sweep is exact on both sides (every chunk
below PALLAS_MIN_ROWS takes the exact blocked scan), so rows are equal
except where two adjacent hits tie, and distances agree within 1e-5
relative (the packages' f32 sums run in other orders). The projected read
is approximate: its rows overlap the reference's by >= 0.99. Also:
`merge_topk`'s tie order against `jnp.argsort`, a host checkpoint written
by either package opened by the other (engine data dirs and
`index_io` directly), `from_reference_state`, the concurrent first fit
of the auto projection, and the Engine's `kind="host"` wiring.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_native import private_reference_native

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu.index.hostarena import HostArenaIndex as JHost
from kektordb_tpu.index.hostarena import _merge_topk as jmerge
from kektordb_tpu.persist import checkpoint as jckpt
from kektordb_tpu.persist import index_io as jio
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index import hostarena
from kektordb_tpu_torch.index.hostarena import HostArenaIndex
from kektordb_tpu_torch.persist import checkpoint as ckpt
from kektordb_tpu_torch.persist import index_io

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's replay scans on its C++ library, built for this
    module alone."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def pair(n=5000, d=24, metric="euclidean", precision="float32",
         chunk=2048, seed=0, data=None, **kw):
    """(reference index, port index, X) holding the same rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) if data is None else data
    ids = [f"v{i}" for i in range(len(X))]
    a = JHost(d, metric, precision, chunk_rows=chunk, **kw)
    b = HostArenaIndex(d, metric, precision, chunk_rows=chunk, device="cpu",
                       **kw)
    a.add_batch(ids, X)
    b.add_batch(ids, X)
    return a, b, X


def same_rows(ra, rb, da):
    """Rows equal, except where the reference's distances tie with a
    neighbour (either order is right there)."""
    diff = ra != rb
    for b, j in zip(*np.nonzero(diff)):
        row = da[b]
        tied = (j > 0 and row[j - 1] == row[j]) or \
            (j + 1 < row.size and row[j + 1] == row[j])
        assert tied, (b, j, ra[b], rb[b], da[b])


def check_same(a, b, Q, k, **kw):
    da, ra = a.search(Q, k, **kw)
    db, rb = b.search(Q, k, **kw)
    assert db.shape == da.shape and rb.shape == ra.shape
    assert db.dtype == np.float32 and rb.dtype == np.int64
    same_rows(ra, rb, da)
    fin = np.isfinite(da)
    assert (np.isfinite(db) == fin).all()
    np.testing.assert_allclose(db[fin], da[fin], rtol=RTOL, atol=1e-6)
    return db, rb


def queries(d, B=33, seed=9):
    return np.random.default_rng(seed).normal(size=(B, d)).astype(
        np.float32)


def overlap(ra, rb):
    k = ra.shape[1]
    return np.mean([len(set(ra[i][ra[i] >= 0]) & set(rb[i][rb[i] >= 0]))
                    / k for i in range(ra.shape[0])])


@pytest.mark.parametrize("metric,precision,d", [
    ("euclidean", "float32", 24),
    ("cosine", "float32", 24),
    ("cosine", "int8", 32),
    ("euclidean", "bfloat16", 16),
])
def test_fulldim_matches_reference(metric, precision, d):
    a, b, X = pair(d=d, metric=metric, precision=precision)
    assert b._cap == a._cap == 8192 and b._cap > b.chunk_rows   # 4 chunks
    check_same(a, b, queries(d), 10)
    for e in ("v0", "v2049", "v4999"):
        np.testing.assert_array_equal(a.get_vector(e), b.get_vector(e))
    assert b.memory_report() == a.memory_report()
    assert b.last_sweep["chunks"] == 3      # the empty 4th is skipped


def test_filtered_bool_and_row_masks():
    a, b, X = pair(n=4000, chunk=1024)
    Q = queries(24, 20)
    allow = np.zeros(a._cap, bool)
    allow[::7] = True
    _, r = check_same(a, b, Q, 5, allow_rows=allow)
    assert (r[r >= 0] % 7 == 0).all()
    # int rows with the -1 missing-id sentinel, which must not wrap
    _, r = check_same(a, b, Q[:4], 2, allow_rows=np.array([3, 2100, -1]))
    assert set(r[r >= 0].ravel()) <= {3, 2100}
    # a mask that empties whole chunks
    allow = np.zeros(a._cap, bool)
    allow[3000:3010] = True
    check_same(a, b, Q, 12, allow_rows=allow)


def test_delete_and_reuse():
    a, b, X = pair(n=3000, chunk=1024)
    for idx in (a, b):
        assert idx.delete("v3") and not idx.delete("v3")
    d, r = check_same(a, b, X[3:4] + 0.1, 3)
    assert 3 not in r
    for idx in (a, b):
        idx.add("back", X[3] + 0.5)       # the freed row is reused
    _, r = check_same(a, b, X[3:4] + 0.5 + 0.01, 1)
    assert b.ids.row_to_ext[r[0, 0]] == "back"


def test_odd_batch_is_not_padded():
    a, b, X = pair(n=2000, chunk=1024)
    d, r = check_same(a, b, queries(24, 7), 3)
    assert d.shape == (7, 3)
    d, r = b.search(X[:7], 3)
    assert (r[:, 0] == np.arange(7)).all()


def test_empty_and_errors():
    b = HostArenaIndex(8, chunk_rows=1024, device="cpu")
    d, r = b.search(np.zeros(8, np.float32), 5)
    assert (r == -1).all() and np.isinf(d).all()
    with pytest.raises(ValueError):
        HostArenaIndex(8, chunk_rows=1000, device="cpu")
    with pytest.raises(ValueError):
        HostArenaIndex(8, metric="nope", device="cpu")
    b.add("a", np.ones(8, np.float32))
    with pytest.raises(ValueError):
        b.add("b", np.ones(9, np.float32))
    with pytest.raises(KeyError):
        b.add("a", np.ones(8, np.float32))
    assert b._cap == 1024 and not b._vectors.is_pinned()


def test_int8_l2_rescaled_like_reference():
    a, b, X = pair(n=2000, d=24, precision="int8", chunk=1024)
    check_same(a, b, X[:16] + 0.5, 4)


def test_geometric_growth():
    b = HostArenaIndex(8, chunk_rows=1024, device="cpu")
    b.add("a", np.ones(8, np.float32))
    assert b._cap == 1024
    b.add_batch([f"b{i}" for i in range(1500)],
                np.ones((1500, 8), np.float32))
    assert b._cap == 2048 and b.grow_seconds > 0


def aniso(n, d, seed=3):
    rng = np.random.default_rng(seed)
    spectrum = np.exp(-np.arange(d) / 6.0)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    return ((rng.normal(size=(n, d)) * spectrum) @ basis.T).astype(
        np.float32)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_projected_explicit_p(metric):
    X = aniso(5000, 48)
    a, b, _ = pair(d=48, metric=metric, data=X, proj_dim=12,
                   proj_rerank=48)
    Q = X[:64] + 0.05 * queries(48, 64)
    da, ra = a.search(Q, 10)
    db, rb = b.search(Q, 10)
    assert b._proj_basis is not None and b._proj_vecs.dtype == torch.int8
    assert overlap(ra, rb) >= 0.99
    # the same rows: the same exact re-rank, d = |x|^2 - 2 q.x + |q|^2 in
    # f32, whose error is a few ulp of the terms (~1e-5 here), not of d
    m = ra == rb
    np.testing.assert_allclose(db[m], da[m], rtol=RTOL, atol=1e-5)
    assert "rerank_s" in b.last_sweep


def test_projected_streaming_add_and_filter():
    X = aniso(3000, 48)
    a, b, _ = pair(d=48, data=X, proj_dim=12, proj_rerank=48)
    fresh = (X[0] * -4.0).astype(np.float32)
    for idx in (a, b):
        idx.add("fresh", fresh)
    _, r = b.search(fresh, 1)
    assert b.ids.row_to_ext[int(r[0, 0])] == "fresh"
    allow = np.zeros(b._cap, bool)
    allow[::4] = True
    Q = X[:20] + 0.05 * queries(48, 20)
    _, ra = a.search(Q, 5, allow_rows=allow)
    _, rb = b.search(Q, 5, allow_rows=allow)
    assert (rb[rb >= 0] % 4 == 0).all() and overlap(ra, rb) >= 0.99


def test_proj_dim_not_below_dim_keeps_full_sweep():
    a, b, X = pair(n=300, d=16, chunk=1024, proj_dim=64)
    check_same(a, b, queries(16, 5), 3)
    assert b._proj_basis is None


def test_auto_projection_past_one_chunk():
    X = np.random.default_rng(0).normal(size=(2200, 64)).astype(np.float32)
    a, b, _ = pair(n=1200, d=64, chunk=1024, data=X[:1200])
    assert b._proj_auto and b.proj_dim == 0
    Q = X[:32] + 0.01
    da, ra = a.search(Q, 5)
    db, rb = b.search(Q, 5)
    assert b.proj_dim == a.proj_dim == 32 and b._proj_basis is not None
    assert overlap(ra, rb) >= 0.99
    assert list(rb[:4, 0]) == [0, 1, 2, 3]


def test_auto_stays_off_small_and_low_dim():
    _, b, X = pair(n=500, d=64, chunk=1024)
    b.search(X[:2], 3)
    assert b.proj_dim == 0 and b._proj_basis is None
    _, b, X = pair(n=2048, d=32, chunk=1024)
    b.search(X[:2], 3)
    assert b.proj_dim == 0
    _, b, X = pair(n=2048, d=64, chunk=1024, proj_dim=0)
    b.search(X[:2], 3)
    assert b.proj_dim == 0 and b._proj_basis is None and not b._proj_auto


def test_concurrent_first_fit_publishes_atomically():
    """The auto projection's first fit runs on the search path, which the
    engine serves under the shared side of its lock: concurrent searches
    see no partial mirror, and every one gets the right top-1."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(4096, 64)).astype(np.float32)
    b = HostArenaIndex(64, chunk_rows=1024, device="cpu")
    b.add_batch([f"v{i}" for i in range(4096)], X)
    assert b._proj_basis is None
    Q = X[:8] + 0.001 * rng.normal(size=(8, 64)).astype(np.float32)
    errs, bad = [], []
    start = threading.Barrier(6)

    def worker():
        try:
            start.wait()
            for _ in range(3):
                _, rows = b.search(Q, 3)
                if not (rows[:, 0] == np.arange(8)).all():
                    bad.append(rows[:, 0].tolist())
        except Exception as exc:            # noqa: BLE001
            errs.append(repr(exc))

    ts = [threading.Thread(target=worker) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert not errs and not bad, (errs, bad[:3])
    assert b.proj_dim == 32 and b._proj_basis is not None


def test_merge_topk_tie_order_matches_argsort():
    rng = np.random.default_rng(1)
    best_d = np.sort(rng.integers(0, 4, size=(16, 6)), 1).astype(
        np.float32)
    best_d[:, -1] = np.inf
    best_r = rng.integers(0, 100, size=(16, 6)).astype(np.int32)
    d = rng.integers(0, 4, size=(16, 9)).astype(np.float32)
    d[::3, -2:] = np.inf
    r = rng.integers(100, 200, size=(16, 9)).astype(np.int32)
    wd, wr = jmerge(jnp.asarray(best_d), jnp.asarray(best_r),
                    jnp.asarray(d), jnp.asarray(r))
    gd, gr = hostarena.merge_topk(*(torch.from_numpy(x) for x in
                                    (best_d, best_r, d, r)))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


@pytest.mark.parametrize("precision,kw", [
    ("float32", {}), ("float32", {"proj_dim": 12}),
    ("bfloat16", {}), ("int8", {"metric": "cosine"}),
])
def test_from_reference_state(precision, kw):
    X = aniso(3000, 48)
    a, b, _ = pair(n=3000, d=48, precision=precision, data=X, chunk=1024,
                   **kw)
    a.delete("v5")
    arrays = {}
    st = jio.dump_index(a, "h", arrays)
    c = HostArenaIndex.from_reference_state(
        st, {leaf: arrays[f"h/{leaf}"] for leaf in
             ("vectors", "norms", "valid")}, device="cpu")
    c.chunk_rows = 1024              # the chunk is a knob, not state
    assert c._cap == a._cap and len(c) == len(a) == 2999
    assert c.proj_dim == a.proj_dim and c._proj_auto == a._proj_auto
    for e in ("v0", "v1500", "v2999"):
        np.testing.assert_array_equal(c.get_vector(e), a.get_vector(e))
    assert c.get_vector("v5") is None
    Q = X[:16] + 0.05 * queries(48, 16)
    if c.proj_dim:
        _, ra = a.search(Q, 10)
        _, rc = c.search(Q, 10)
        assert overlap(ra, rc) >= 0.99
    else:
        check_same(a, c, Q, 10)


def test_index_io_round_trips_both_ways():
    X = np.random.default_rng(4).normal(size=(1500, 64)).astype(np.float32)
    a, b, _ = pair(n=1500, d=64, chunk=1024, data=X)
    # port -> reference: the port's arrays, as its checkpoint stores them
    arrays = {}
    st = index_io.dump_index(b, "h", arrays)
    enc = ckpt.encode_arrays(arrays)
    a2 = jio.load_index(st, jckpt._decode_arrays(enc), "h")
    assert isinstance(a2, JHost) and a2._proj_auto
    a2.chunk_rows = 1024
    # reference -> port
    arrays = {}
    st = jio.dump_index(a, "h", arrays)
    b2 = index_io.load_index(st, {k: torch.from_numpy(np.array(v))
                                  for k, v in arrays.items()}, "h",
                             device="cpu")
    assert isinstance(b2, HostArenaIndex) and b2._proj_auto
    b2.chunk_rows = 1024
    Q = X[:8] + 0.01
    _, r1 = a2.search(Q, 3)
    _, r2 = b2.search(Q, 3)
    assert a2.proj_dim == b2.proj_dim == 32
    assert overlap(r1, r2) >= 0.99 and (r2[:, 0] == np.arange(8)).all()


@pytest.fixture
def clock(monkeypatch):
    c = [1.75e9]
    monkeypatch.setattr(time, "time", lambda: c[0])
    return c


def _port(d):
    return Engine(EngineConfig(device="cpu", data_dir=str(d),
                               start_background=False)).open()


def _ref(d):
    return JEngine(JEngineConfig(data_dir=str(d),
                                 start_background=False)).open()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("kw", [
    {}, {"precision": "bfloat16"}, {"metric": "cosine", "precision": "int8"},
    {"serve_proj_dim": 6, "serve_proj_rerank": 32}])
def test_host_checkpoint_opens_in_the_other_package(tmp_path, clock,
                                                    writer, kw):
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(400, 24)) * np.exp(-np.arange(24) / 4.0)
         ).astype(np.float32)
    w = (_ref if writer == "ref" else _port)(tmp_path)
    w.create_index("h", kind="host", **kw)
    w.add_batch("h", [f"v{i}" for i in range(400)], X,
                [{"grp": i % 3} for i in range(400)])
    w.delete("h", "v9")
    Q = X[:6] + 0.01
    want = w.search("h", Q, k=4)
    wantf = w.search("h", Q, k=4, filter="grp = 1")
    clock[0] += 1.0
    w.close()
    r = (_port if writer == "ref" else _ref)(tmp_path)
    idx = r.indexes["h"].index
    assert len(idx) == 399 and idx.get_vector("v9") is None
    np.testing.assert_array_equal(idx.get_vector("v7"),
                                  w.indexes["h"].index.get_vector("v7"))
    assert idx.proj_dim == w.indexes["h"].index.proj_dim
    for a, b in ((want, r.search("h", Q, k=4)),
                 (wantf, r.search("h", Q, k=4, filter="grp = 1"))):
        assert [[h["id"] for h in q] for q in a] == \
            [[h["id"] for h in q] for q in b]
        np.testing.assert_allclose(
            [[h["distance"] for h in q] for q in a],
            [[h["distance"] for h in q] for q in b], rtol=RTOL, atol=1e-5)
    clock[0] += 1.0
    r.close()


def test_engine_host_lifecycle_and_knobs():
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    X = np.random.default_rng(2).normal(size=(300, 16)).astype(np.float32)
    e.create_index("h", kind="host")
    e.add_batch("h", [f"v{i}" for i in range(300)], X,
                [{"grp": i % 3} for i in range(300)])
    idx = e.indexes["h"].index
    assert isinstance(idx, HostArenaIndex) and idx._proj_auto
    assert e.search("h", X[9], k=1)[0][0]["id"] == "v9"
    hits = e.search("h", X[9], k=5, filter="grp = 0",
                    include_metadata=True)[0]
    assert hits and all(h["metadata"]["grp"] == 0 for h in hits)
    info = e.index_info("h")
    assert info["config"] == {"chunk_rows": hostarena.CHUNK_ROWS,
                              "proj_dim": 0, "proj_rerank": 128}
    e.configure_index("h", {"serve_proj_dim": 4, "serve_proj_rerank": 16})
    assert idx.proj_dim == 4 and not idx._proj_auto and idx.proj_rerank == 16
    assert e.search("h", X[11], k=1)[0][0]["id"] == "v11"
    assert idx._proj_basis is not None
    assert e._live_rows(e.indexes["h"]) == set(range(300))
    assert e.delete("h", "v9")
    assert e.search("h", X[9], k=1)[0][0]["id"] != "v9"
    assert 9 not in e._live_rows(e.indexes["h"])
    e.close()
