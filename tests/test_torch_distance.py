"""Parity of the port's distances and int8 quantizer with the JAX package:
the same numpy inputs, made from a seed, go through both.

Tolerances: float32 results may differ in the last bits because the two
frameworks sum products in another order, so float distances are held to
rtol 1e-5 with an absolute floor of 1e-4 (cancellation in
|q|^2 - 2 q.x + |x|^2 near zero). Integer results (int8 codes, int-domain
dots) must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kektordb_tpu.ops import distance as jdist
from kektordb_tpu.ops import quantize as jquant
from kektordb_tpu_torch.ops import distance as tdist
from kektordb_tpu_torch.ops import quantize as tquant

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def data(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_codes_bit_equal():
    X = data(3000, 32, 0) * 3.0
    js = jquant.train(jnp.asarray(X))
    ts = tquant.train(t(X))
    assert float(js.abs_max) == float(ts.abs_max)
    jc, jn = jquant.quantize(js, jnp.asarray(X))
    tc, tn = tquant.quantize(ts, t(X))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_array_equal(np.asarray(jquant.dequantize(js, jc)),
                                  tquant.dequantize(ts, tc).numpy())


def test_quantize_rowwise_bit_equal():
    X = unit(data(1000, 48, 1))
    jc, jn = jquant.quantize_rowwise(jnp.asarray(X))
    tc, tn = tquant.quantize_rowwise(t(X))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


def test_round_half_even_like_rint():
    halves = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5]],
                      np.float32)
    st = tquant.QuantizerState(torch.tensor(127.0), True)
    js = jquant.QuantizerState(jnp.float32(127.0), jnp.array(True))
    np.testing.assert_array_equal(
        np.asarray(jquant.quantize(js, jnp.asarray(halves))[0]),
        tquant.quantize(st, t(halves))[0].numpy())


def test_fit_pca_basis_equal():
    X = data(500, 16, 2)
    np.testing.assert_array_equal(jquant.fit_pca_basis(X, 4),
                                  tquant.fit_pca_basis(X, 4))


def test_normalize():
    X = data(64, 16, 3)
    X[5] = 0.0
    np.testing.assert_allclose(np.asarray(jdist.normalize(jnp.asarray(X))),
                               tdist.normalize(t(X)).numpy(),
                               rtol=RTOL, atol=1e-6)


def _int8_inputs(seed):
    X, Q = unit(data(512, 32, seed)), unit(data(16, 32, seed + 1))
    st = jquant.train(jnp.asarray(X))
    codes, norms = (np.asarray(a) for a in jquant.quantize(st, jnp.asarray(X)))
    qc, qn = (np.asarray(a) for a in jquant.quantize(st, jnp.asarray(Q)))
    return X, Q, codes, norms, qc, qn, float(st.abs_max) / 127.0


@pytest.mark.parametrize("case", ["f32_l2", "f32_cos", "bf16_l2",
                                  "int8_cos", "int8_l2"])
def test_pairwise(case):
    if case.startswith("int8"):
        _, _, codes, norms, qc, qn, _ = _int8_inputs(10)
        metric = jdist.COSINE if case == "int8_cos" else jdist.L2
        j = jdist.pairwise(jnp.asarray(qc), jnp.asarray(codes), metric,
                           corpus_norms=jnp.asarray(norms),
                           query_norms=jnp.asarray(qn))
        tt = tdist.pairwise(t(qc), t(codes), metric, corpus_norms=t(norms),
                            query_norms=t(qn))
    else:
        X, Q = data(512, 32, 11), data(16, 32, 12)
        metric = jdist.COSINE if case == "f32_cos" else jdist.L2
        if metric == jdist.COSINE:
            X, Q = unit(X), unit(Q)
        jx, tx = jnp.asarray(X), t(X)
        if case == "bf16_l2":
            jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        j = jdist.pairwise(jnp.asarray(Q), jx, metric)
        tt = tdist.pairwise(t(Q), tx, metric)
    np.testing.assert_allclose(np.asarray(j), tt.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["f32_l2", "f32_cos", "bf16_l2",
                                  "int8_sym_cos", "int8_sym_l2",
                                  "int8_asym_cos", "int8_asym_l2"])
def test_gathered_all_branches(case):
    """All four dtype branches of `gathered`; ids padded with -1."""
    rng = np.random.default_rng(20)
    ids = rng.integers(0, 512, size=(16, 24)).astype(np.int32)
    ids[:, -3:] = -1
    kw_j, kw_t = {}, {}
    if case.startswith("int8"):
        X, Q, codes, norms, qc, qn, quantum = _int8_inputs(21)
        vj, vt = jnp.asarray(codes), t(codes)
        kw_j["corpus_norms"], kw_t["corpus_norms"] = (jnp.asarray(norms),
                                                      t(norms))
        if "_sym_" in case:
            qj, qt = jnp.asarray(qc), t(qc)
            kw_j["query_norms"], kw_t["query_norms"] = (jnp.asarray(qn),
                                                        t(qn))
        else:
            qj, qt = jnp.asarray(Q), t(Q)
            if case.endswith("l2"):
                kw_j["quantum"] = jnp.float32(quantum)
                kw_t["quantum"] = torch.tensor(quantum, dtype=torch.float32)
        metric = jdist.COSINE if case.endswith("cos") else jdist.L2
    else:
        X, Q = data(512, 32, 22), data(16, 32, 23)
        metric = jdist.COSINE if case == "f32_cos" else jdist.L2
        if metric == jdist.COSINE:
            X, Q = unit(X), unit(Q)
        vj, vt = jnp.asarray(X), t(X)
        if case == "bf16_l2":
            vj, vt = vj.astype(jnp.bfloat16), vt.to(torch.bfloat16)
            qj, qt = jnp.asarray(Q).astype(jnp.bfloat16), t(Q).to(
                torch.bfloat16)
        else:
            qj, qt = jnp.asarray(Q), t(Q)
    j = np.asarray(jdist.gathered(vj, jnp.asarray(ids), qj, metric, **kw_j))
    tt = tdist.gathered(vt, t(ids), qt, metric, **kw_t).numpy()
    assert np.isinf(tt[:, -3:]).all()
    np.testing.assert_allclose(j, tt, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", [jdist.L2, jdist.COSINE])
def test_brute_force_topk_equal_ids(metric):
    """The oracle: equal ids, several blocks merged, a validity mask."""
    X, Q = data(2500, 24, 30), data(20, 24, 31)
    if metric == jdist.COSINE:
        X, Q = unit(X), unit(Q)
    valid = np.random.default_rng(32).random(2500) > 0.3
    jd, ji = jdist.brute_force_topk(jnp.asarray(Q), jnp.asarray(X), 10,
                                    metric, valid=jnp.asarray(valid),
                                    block=1024)
    td, ti = tdist.brute_force_topk(t(Q), t(X), 10, metric, valid=t(valid),
                                    block=1024)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_brute_force_topk_int8_and_padding():
    """k larger than the valid rows pads with inf / -1 like the reference."""
    _, _, codes, norms, qc, qn, _ = _int8_inputs(40)
    valid = np.zeros(512, bool)
    valid[:5] = True
    args_j = dict(valid=jnp.asarray(valid), corpus_norms=jnp.asarray(norms),
                  query_norms=jnp.asarray(qn))
    args_t = dict(valid=t(valid), corpus_norms=t(norms), query_norms=t(qn))
    jd, ji = jdist.brute_force_topk(jnp.asarray(qc), jnp.asarray(codes), 8,
                                    jdist.COSINE, **args_j)
    td, ti = tdist.brute_force_topk(t(qc), t(codes), 8, jdist.COSINE,
                                    **args_t)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert (ti[:, 5:] == -1).all() and torch.isinf(td[:, 5:]).all()
    np.testing.assert_allclose(np.asarray(jd)[:, :5], td[:, :5].numpy(),
                               rtol=RTOL, atol=ATOL)
