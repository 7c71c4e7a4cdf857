"""Parity of the port's scan-serving HNSW index with the JAX package's:
the same add_batch / add / delete / vacuum sequence, on the same seeded
numpy data, under serve_mode="scan", gives the same rows and distances.

Tolerance: distances within rtol 1e-5 (float32 sums in another order),
with an absolute floor of 1e-4 for cancellation near zero (a query's
distance to itself). Rows must be equal."""

import jax
import numpy as np
import pytest
import torch

from kektordb_tpu.index import HNSWConfig as JConfig
from kektordb_tpu.index import HNSWIndex as JIndex
from kektordb_tpu_torch.index import HNSWConfig, HNSWIndex
from kektordb_tpu_torch.index import hnsw_kernels as K

RTOL, ATOL = 1e-5, 1e-4
N0, D = 3000, 32

# (metric, precision) families the index serves
FAMILIES = [("euclidean", "float32"), ("cosine", "float32"),
            ("euclidean", "bfloat16"), ("cosine", "int8")]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def data(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def sequence(idx, X, Q):
    """One write/read sequence; returns the searches' (dists, rows) and
    the number of rows vacuum purged (a pending row deleted before it was
    staged is dropped host-side and never needs purging)."""
    idx.add_batch([f"v{i}" for i in range(N0)], X[:N0])
    for i in range(N0, N0 + 70):     # > flush_chunk: one staged, 6 pending
        idx.add(f"v{i}", X[i])
    for i in range(0, N0 + 70, 7):
        idx.delete(f"v{i}")
    out = [idx.search(Q, 10)]
    purged = idx.vacuum()
    idx.add_batch([f"w{i}" for i in range(300)], X[N0 + 70:N0 + 370])
    allow = np.zeros(N0 + 70, bool)
    allow[::3] = True
    out += [idx.search(Q, 10), idx.search(Q[:5], 7, allow_rows=allow)]
    return out, purged


@pytest.fixture(scope="module", params=FAMILIES,
                ids=[f"{m}-{p}" for m, p in FAMILIES])
def pair(request):
    metric, precision = request.param
    X, Q = data(N0 + 400, D, 0), data(20, D, 1)
    ref = JIndex(D, metric, precision,
                 config=JConfig(m=8, serve_mode="scan"))
    port = HNSWIndex(D, metric, precision,
                     config=HNSWConfig(m=8, serve_mode="scan"),
                     device="cpu")
    return ref, port, sequence(ref, X, Q), sequence(port, X, Q)


def test_sequence_same_rows_and_distances(pair):
    _, _, (ref_out, ref_purged), (port_out, port_purged) = pair
    assert ref_purged == port_purged == len(range(0, N0 + 64, 7))
    for (jd, jr), (td, tr) in zip(ref_out, port_out):
        np.testing.assert_array_equal(jr, tr)
        np.testing.assert_allclose(jd, td, rtol=RTOL, atol=ATOL)


def test_same_state_layout_and_host_maps(pair):
    ref, port, _, _ = pair
    jst = jax.device_get(ref.state)
    for f in K.GraphState._fields:
        a, b = np.asarray(getattr(jst, f)), getattr(port.state, f)
        assert a.shape == tuple(b.shape), f
        assert a.dtype.itemsize == b.element_size(), f
    np.testing.assert_array_equal(np.asarray(jst.levels),
                                  port.state.levels.numpy())
    np.testing.assert_array_equal(np.asarray(jst.deleted),
                                  port.state.deleted.numpy())
    assert ref.ids.row_to_ext == port.ids.row_to_ext
    assert ref.memory_report() == port.memory_report()
    for e in ("v1", "v3001", "w5"):
        np.testing.assert_allclose(ref.get_vector(e), port.get_vector(e),
                                   rtol=RTOL, atol=1e-6)
    assert port.get_vector("v0") is None


@pytest.mark.parametrize("metric,precision", [("euclidean", "float32"),
                                              ("cosine", "int8")])
def test_from_reference_state(metric, precision):
    """A JAX-built index carried across answers the same queries, and later
    adds sample the same levels and rows on both sides."""
    X, Q = data(2000, D, 4), data(16, D, 5)
    ref = JIndex(D, metric, precision, config=JConfig(m=8, serve_mode="scan"))
    ref.add_batch([f"v{i}" for i in range(1500)], X[:1500])
    for i in range(0, 1500, 5):
        ref.delete(f"v{i}")
    ref.settle_for_serving()
    port = HNSWIndex.from_reference_state(
        jax.device_get(ref.state)._asdict(),
        {"row_to_ext": ref.ids.row_to_ext, "free": ref.ids.free},
        HNSWConfig(m=8, serve_mode="scan"), metric=metric,
        precision=precision, device="cpu",
        mirrors={"deleted_rows": ref._deleted_rows,
                 "abs_max": float(ref.quantizer.abs_max)
                 if bool(ref.quantizer.trained) else None,
                 "rng_state": ref.rng.bit_generator.state})
    for idx in (ref, port):
        idx.add_batch([f"n{i}" for i in range(300)], X[1500:1800])
    (jd, jr), (td, tr) = ref.search(Q, 10), port.search(Q, 10)
    np.testing.assert_array_equal(jr, tr)
    np.testing.assert_allclose(jd, td, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.asarray(ref.state.levels),
                                  port.state.levels.numpy())
    assert port.vacuum() == ref.vacuum() == 300


def test_padded_chunk_never_writes_last_row():
    """-1 padding would wrap to row cap-1 in a torch scatter: every state
    mutator masks it out."""
    st = K.init_state(16, 4, torch.float32, m0=4, lmax=2, mu=2, ucap=8,
                      device="cpu")
    rows = torch.tensor([0, 1, -1, -1], dtype=torch.int32)
    vecs = torch.ones((4, 4))
    st = K.stage_vectors(st, rows, vecs, torch.full((4,), 4.0),
                         torch.zeros(4, dtype=torch.int32))
    assert st.levels[:2].tolist() == [0, 0] and st.levels[-1] == -1
    assert (st.vectors[-1] == 0).all() and st.norms[-1] == 0
    assert int(st.size) == 2
    st = K.mark_deleted(st, torch.tensor([-1, 1], dtype=torch.int32))
    assert st.deleted.tolist() == [False, True] + [False] * 14
    st.vectors[-1] = 7.0
    st.nbrs[-1, 0] = 0
    st = K.purge_rows(st, torch.tensor([1, -1], dtype=torch.int32),
                      torch.tensor([-1], dtype=torch.int32))
    assert (st.vectors[-1] == 7.0).all() and st.nbrs[-1, 0] == 0
    assert st.levels[1] == -1 and (st.vectors[1] == 0).all()
    assert (st.up_node == -1).all()


def test_grow_keeps_rows_searchable():
    X = data(5000, 8, 6)
    idx = HNSWIndex(8, config=HNSWConfig(serve_mode="scan"), device="cpu")
    idx.add_batch([f"v{i}" for i in range(5000)], X)
    assert idx.state.vectors.shape[0] == 8192
    assert idx.state.up_node.shape[0] == max(2 * 8192 // 16, 256)
    _, rows = idx.search(X[[0, 4999]], 1)
    assert rows[:, 0].tolist() == [0, 4999]


def _linked_scan_index():
    idx = HNSWIndex(4, config=HNSWConfig(serve_mode="scan"), device="cpu")
    idx.add_batch(["a"], np.ones((1, 4)), link=True)
    return idx


# options that once raised NotImplementedError (the serve modes the graph
# slice ported, serve_proj_dim): each call runs
@pytest.mark.parametrize("call", [
    lambda: HNSWIndex(4, device="cpu"),                        # "auto"
    lambda: HNSWIndex(4, config=HNSWConfig(serve_mode="beam"),
                      device="cpu"),
    lambda: HNSWIndex(4, config=HNSWConfig(serve_mode="scan",
                                           serve_proj_dim=2),
                      device="cpu"),
    _linked_scan_index,
    lambda: HNSWIndex(4, config=HNSWConfig(serve_mode="scan"),
                      device="cpu").search(np.ones((1, 4)), 1, mode="beam"),
], ids=[f"call{i}" for i in range(5)])
def test_deferred_options_raise(call):
    out = call()
    if isinstance(out, HNSWIndex):
        assert out.config.serve_mode in ("auto", "beam", "scan")
        if len(out):      # add_batch(link=True): the row is linked
            assert int(out.state.entry) == 0
    else:                 # beam search of an empty index: -1 / +inf
        assert out[1].tolist() == [[-1]] and np.isinf(out[0]).all()
