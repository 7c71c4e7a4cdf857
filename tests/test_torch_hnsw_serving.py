"""The rest of HNSWIndex against the JAX package: compress_serving, the
PCA-projected read (serve_proj_dim) and optimize_layout.

Each reference index is built by the JAX package, then carried into the
port through the checkpoint path (`index_io.dump_index` of the
reference, `load_index` of the port), so both start from one state.
* compress_serving (bf16; int8 for L2 and cosine): the narrowed arena is
  bit-equal, norms within rtol 1e-6, the quantizer equal; scan reads give
  the same rows (distances rtol 1e-5, floor 1e-4), beam reads the same
  rows on >= 99% of entries (float32 sums in another order can swap
  near-ties). The reference's int8 cosine gate (tests/test_int8_asym.py:
  88-106) holds in the port.
* The projected read (L2, cosine, a bf16 arena, an allow mask, deleted
  rows): the same PCA basis, projected norms within rtol 1e-5, and the
  final rows after the exact re-rank overlapping the reference's on >=
  99% of entries, with equal distances where the rows agree. The query's
  projection is rounded to bf16 after an f32 product whose order differs
  between the packages, so candidates near a rounding boundary may differ.
* optimize_layout: the same permutation (every GraphState leaf and the id
  maps equal after it), results preserved; skipped when rows were freed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kektordb_tpu.index import HNSWConfig as JConfig
from kektordb_tpu.index import HNSWIndex as JIndex
from kektordb_tpu.ops import distance as jdist
from kektordb_tpu.persist import checkpoint as jckpt
from kektordb_tpu.persist import index_io as jio
from kektordb_tpu_torch.index import HNSWIndex
from kektordb_tpu_torch.persist import checkpoint, index_io

RTOL, ATOL = 1e-5, 1e-4
MATCH = 0.99
N, D = 1500, 32


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def data(n, d, seed, spectrum=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if spectrum is not None:          # anisotropic: a decaying spectrum
        basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
        X = (X * np.exp(-np.arange(d) / spectrum)) @ basis.T
    return X.astype(np.float32)


def carry(jidx):
    """(a fresh reference copy, the port's copy) of a reference index,
    through both packages' checkpoint code."""
    arrays = {}
    st = jio.dump_index(jidx, "x", arrays)
    enc = {k: np.array(a) for k, a in jckpt._encode_arrays(arrays).items()}
    ref = jio.load_index(st, jckpt._decode_arrays(enc), "x")
    port = index_io.load_index(st, checkpoint.decode_arrays(enc), "x",
                               device="cpu")
    return ref, port


def leaves(ref, port):
    """Both GraphStates as numpy, bf16 as its bit pattern."""
    def np_(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return ({k: np_(v) for k, v in jax.device_get(ref.state)._asdict()
             .items()},
            {k: (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
             .numpy() for k, t in port.state._asdict().items()})


def same_rows(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.fixture(scope="module")
def graph_refs():
    """Linked reference indexes (serve_mode "auto", upper levels), L2 and
    cosine, built once."""
    X = data(N, D, 1)
    out = {}
    for metric in ("euclidean", "cosine"):
        j = JIndex(D, metric, config=JConfig(m=8, ef_construction=64,
                                             ef_search=64, chunk=256))
        j.add_batch([f"v{i}" for i in range(N)], X)
        j.settle_for_serving()
        out[metric] = j
    return out


@pytest.mark.parametrize("metric,dtype", [("euclidean", "bfloat16"),
                                          ("euclidean", "int8"),
                                          ("cosine", "int8"),
                                          ("cosine", "bfloat16")])
def test_compress_serving_matches_reference(graph_refs, metric, dtype):
    ref, port = carry(graph_refs[metric])
    ref.compress_serving(dtype)
    port.compress_serving(dtype)
    (jl, tl) = leaves(ref, port)
    assert tl["vectors"].dtype == jl["vectors"].dtype
    np.testing.assert_array_equal(tl["vectors"], jl["vectors"])
    np.testing.assert_allclose(tl["norms"], jl["norms"], rtol=1e-6)
    assert port._serve_quantized == ref._serve_quantized
    assert float(port.quantizer.abs_max) == float(ref.quantizer.abs_max)
    Q = data(24, D, 2)
    (jd, jr), (td, tr) = ref.search(Q, 10), port.search(Q, 10)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    (jd, jr) = ref.search(Q, 10, mode="beam")
    (td, tr) = port.search(Q, 10, mode="beam")
    assert same_rows(tr, jr) >= MATCH
    eq = np.asarray(tr) == np.asarray(jr)
    np.testing.assert_allclose(td[eq], np.asarray(jd)[eq], rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="float32"):
        HNSWIndex(D, "cosine", "int8", device="cpu").compress_serving()


def test_int8_cosine_compress_gate():
    """tests/test_int8_asym.py::test_index_level_int8_compress_asym on the
    port: recall vs the f32 oracle >= 0.95, distances in [0, 2], and the
    device search's rescale 1."""
    from kektordb_tpu_torch.index import HNSWConfig
    from kektordb_tpu_torch.ops import distance as dist
    n = 2048
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(32, 48))[rng.integers(0, 32, n + 32)]
         + 0.3 * rng.normal(size=(n + 32, 48))).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    base, q = X[:n], X[n:]
    idx = HNSWIndex(48, dist.COSINE,
                    config=HNSWConfig(m=8, serve_mode="scan"), device="cpu")
    idx.add_batch([f"v{i}" for i in range(n)], base, link=False)
    gt = np.asarray(jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(base),
                                           10, jdist.COSINE)[1])
    idx.compress_serving("int8")
    dd, rr = idx.search(q, 10)
    hit = np.mean([len(set(rr[b]) & set(gt[b])) for b in range(32)]) / 10
    assert hit >= 0.95
    assert float(np.nanmax(np.where(np.isfinite(dd), dd, 0))) <= 2.01
    res = idx.search_device(q, 10)
    assert res is not None and res[2] == 1.0


# (metric, precision, p, rerank, filtered)
PROJ = [("euclidean", "float32", 8, 32, False),
        ("cosine", "float32", 8, 32, False),
        ("euclidean", "bfloat16", 16, 48, False),
        ("euclidean", "float32", 8, 32, True)]


@pytest.mark.parametrize("metric,precision,p,rerank,filtered", PROJ,
                         ids=[f"proj{i}" for i in range(len(PROJ))])
def test_projected_read_matches_reference(metric, precision, p, rerank,
                                          filtered):
    X = data(N + 64, D, 3, spectrum=5.0)
    base = X[:N]
    Q = X[N:] + 0.01 * data(64, D, 4)
    j = JIndex(D, metric, precision, config=JConfig(
        m=8, serve_mode="scan", serve_proj_dim=p, serve_proj_rerank=rerank))
    j.add_batch([f"v{i}" for i in range(N)], base)
    for i in range(0, N, 11):
        j.delete(f"v{i}")
    j.settle_for_serving()
    ref, port = carry(j)
    allow = None
    if filtered:
        allow = np.zeros(port._cap, bool)
        allow[::3] = True
    (jd, jr) = ref.search(Q, 10, allow_rows=allow)
    (td, tr) = port.search(Q, 10, allow_rows=allow)
    assert port._proj is not None and ref._proj is not None
    np.testing.assert_array_equal(port._proj_basis.numpy(),
                                  np.asarray(ref._proj_basis))
    np.testing.assert_allclose(port._proj[1].numpy(),
                               np.asarray(ref._proj[1]), rtol=RTOL,
                               atol=1e-6)
    assert same_rows(tr, jr) >= MATCH
    eq = np.asarray(tr) == np.asarray(jr)
    np.testing.assert_allclose(td[eq], np.asarray(jd)[eq], rtol=RTOL,
                               atol=ATOL)
    live = tr[tr >= 0]
    assert live.size and not np.isin(live, np.arange(0, N, 11)).any()
    if filtered:
        assert np.all(live % 3 == 0)
    # a write moves the state version: the projection is rebuilt
    version = port._proj_version
    port.add("fresh", (X[1] * -3.0).astype(np.float32))
    _, r = port.search((X[1] * -3.0)[None], 1)
    assert port.ids.row_to_ext[int(r[0, 0])] == "fresh"
    assert port._proj_version != version


def test_optimize_layout_matches_reference(graph_refs):
    ref, port = carry(graph_refs["euclidean"])
    Q = data(24, D, 5)
    before = [port.search_ids(Q, 5), port.search_ids(Q, 5, mode="beam")]
    ref.optimize_layout()
    port.optimize_layout()
    jl, tl = leaves(ref, port)
    for k in jl:
        if k == "norms":
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert port.ids.row_to_ext == ref.ids.row_to_ext
    assert port.ids.ext_to_row == ref.ids.ext_to_row
    after = [port.search_ids(Q, 5), port.search_ids(Q, 5, mode="beam")]
    assert after[0] == before[0]
    same = sum({h[0] for h in b} == {h[0] for h in a}
               for b, a in zip(before[1], after[1]))
    assert same >= len(Q) - 2
    d, i = port.search(data(1, D, 1)[0][None], 1)
    assert port.ids.row_to_ext[int(i[0, 0])] == "v0"
    port.add("new", np.full(D, 9.0, np.float32))
    assert port.search_ids(np.full((1, D), 9.0, np.float32), 1)[0][0][0] \
        == "new"


def test_optimize_layout_skipped_with_deletes(graph_refs):
    _, port = carry(graph_refs["euclidean"])
    port.delete("v5")
    state = {k: t.clone() for k, t in port.state._asdict().items()}
    port.optimize_layout()
    for k, t in port.state._asdict().items():
        assert torch.equal(t, state[k]), k
    assert port.search_ids(data(N, D, 1)[6][None], 1)[0][0][0] == "v6"
