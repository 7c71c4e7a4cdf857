"""The JAX package's tests/test_distance.py against the port's ops/distance
and ops/quantize.

Every case of the reference feeds `jnp` arrays to the op-level functions,
so none runs as it is: its helpers and its `data` fixture are taken from
the reference (test_torch_port_reference), and each case below is the
reference's under its own name, with its assertions and tolerances, on
torch tensors on DEVICE. On the card `dist.gathered` launches the
gather-distance kernel."""

import numpy as np
import torch
from test_torch_port_reference import DEVICE, reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_distance.py", ["np_l2", "np_cos", "data"]),
             "test_distance.py", "exec"))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=DEVICE)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def test_pairwise_l2(data):
    q, x = data
    got = _np(dist.pairwise(_t(q), _t(x), dist.L2))
    np.testing.assert_allclose(got, np_l2(q, x), rtol=1e-4, atol=1e-4)


def test_pairwise_cosine(data):
    q, x = data
    qn = _np(dist.normalize(_t(q)))
    xn = _np(dist.normalize(_t(x)))
    got = _np(dist.pairwise(_t(qn), _t(xn), dist.COSINE))
    np.testing.assert_allclose(got, np_cos(q, x), rtol=1e-4, atol=1e-4)


def test_pairwise_int8_cosine(data):
    q, x = data
    st = quant.train(_t(x))
    xq, xn = quant.quantize(
        st, _t(x / np.linalg.norm(x, axis=1, keepdims=True)))
    qq, qn = quant.quantize(
        st, _t(q / np.linalg.norm(q, axis=1, keepdims=True)))
    got = _np(dist.pairwise(qq, xq, dist.COSINE,
                            corpus_norms=xn, query_norms=qn))
    want = np_cos(q, x)
    assert np.abs(got - want).max() < 0.05  # quantization tolerance


def test_gathered_matches_pairwise(data):
    q, x = data
    ids = np.array([[0, 3, 5, -1], [7, 7, 2, 49]], dtype=np.int32)
    got = _np(dist.gathered(_t(x), _t(ids), _t(q[:2]), dist.L2))
    full = np_l2(q[:2], x)
    for b in range(2):
        for j, i in enumerate(ids[b]):
            if i < 0:
                assert np.isinf(got[b, j])
            else:
                np.testing.assert_allclose(got[b, j], full[b, i], rtol=1e-4)


def test_brute_force_topk(data):
    q, x = data
    d, i = dist.brute_force_topk(_t(q), _t(x), 5, dist.L2)
    want = np.argsort(np_l2(q, x), axis=1)[:, :5]
    np.testing.assert_array_equal(_np(i), want)


def test_brute_force_topk_masked(data):
    q, x = data
    valid = np.zeros(50, bool)
    valid[10:20] = True
    d, i = dist.brute_force_topk(_t(q), _t(x), 5, dist.L2, valid=_t(valid))
    i = _np(i)
    assert ((i >= 10) & (i < 20)).all()
    want = 10 + np.argsort(np_l2(q, x)[:, 10:20], axis=1)[:, :5]
    np.testing.assert_array_equal(i, want)


def test_brute_force_topk_blocked(data):
    """Multiple blocks exercise the scan merge."""
    q, x = data
    d, i = dist.brute_force_topk(_t(q), _t(x), 5, dist.L2, block=16)
    want = np.argsort(np_l2(q, x), axis=1)[:, :5]
    np.testing.assert_array_equal(_np(i), want)


def test_brute_force_k_exceeds_valid(data):
    q, x = data
    valid = np.zeros(50, bool)
    valid[3] = True
    d, i = dist.brute_force_topk(_t(q), _t(x), 5, dist.L2, valid=_t(valid))
    i, d = _np(i), _np(d)
    assert (i[:, 0] == 3).all()
    assert (i[:, 1:] == -1).all()
    assert np.isinf(d[:, 1:]).all()


def test_quantize_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1000, 16)).astype(np.float32)
    st = quant.train(_t(x))
    codes, norms = quant.quantize(st, _t(x))
    back = _np(quant.dequantize(st, codes))
    # 8-bit symmetric quantization: error bounded by one quantum
    quantum = float(st.abs_max) / 127.0
    inliers = np.abs(x) <= float(st.abs_max)
    assert np.abs((back - x) * inliers).max() <= quantum * 0.51 + 1e-6
    np.testing.assert_allclose(
        _np(norms), np.linalg.norm(_np(codes).astype(np.float32), axis=1),
        rtol=1e-5)


def test_quantize_outlier_robust():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5000, 8)).astype(np.float32)
    x[0, 0] = 1e6  # single outlier must not blow up the scale
    st = quant.train(_t(x))
    assert float(st.abs_max) < 100.0
