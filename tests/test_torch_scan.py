"""Parity of the port's fused scan (kektordb_tpu_torch/ops/scan.py) with
the JAX package's (kektordb_tpu/ops/scan.py), on the same seeded numpy
inputs.

* The exact blocked scan against `_scan_xla`, through `scan_search`: equal
  rows. Distances within rtol 1e-5 (float32 sums in another order), with
  an absolute floor of 1e-4 for cancellation near zero.
* The plain pass A against the Pallas `_pass_a` in interpret mode, at the
  TPU's own ST and G: gmin within the same tolerance, garg equal.
* The kernel route's pass B (`_scan_kernel`) against `_scan_pallas` in
  interpret mode, exact mode: equal rows.
* The serving read on the kernel route (fast candidates, exact re-rank)
  against the reference's `scan_search` on its interpret-mode Pallas
  route: equal rows, distances within the same tolerance.
On the CPU, JAX's DEFAULT precision is full float32, not the TPU's single
bf16 pass, so the fast form gets inputs already rounded to bf16 on both
sides. The CUDA kernel itself runs only on a card: chip_smoke.py checks it
against `pass_a_plain` there."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kektordb_tpu.ops import distance as jdist
from kektordb_tpu.ops import quantize as jquant
from kektordb_tpu.ops import scan as jscan
from kektordb_tpu_torch.ops import scan as tscan

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


def _case(kind, n=2048, d=32, b=32, seed=0):
    """numpy inputs for one family: (vectors, norms, q, qn, metric, quantum).
    q is float32 except for int8 symmetric."""
    X, Q = data(n, d, seed), data(b, d, seed + 1)
    quantum = None
    if kind == "l2":
        return X, (X * X).sum(1), Q, np.zeros(b, np.float32), jdist.L2, None
    if kind == "cos":
        X, Q = unit(X), unit(Q)
        return X, np.zeros(n, np.float32), Q, np.ones(b, np.float32), \
            jdist.COSINE, None
    st = jquant.train(jnp.asarray(unit(X)))
    codes, norms = (np.asarray(a) for a in
                    jquant.quantize(st, jnp.asarray(unit(X))))
    if kind == "int8_sym":
        qc, qn = (np.asarray(a) for a in
                  jquant.quantize(st, jnp.asarray(unit(Q))))
        return codes, norms, qc, qn, jdist.COSINE, None
    if kind == "int8_asym_l2":
        quantum = np.float32(float(st.abs_max) / 127.0)
        return codes, norms, Q, np.zeros(b, np.float32), jdist.L2, quantum
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["l2", "cos", "int8_sym", "int8_asym_l2"])
@pytest.mark.parametrize("masked", [False, True])
def test_blocked_scan_matches_scan_xla(kind, masked):
    """scan_search on the CPU takes the exact blocked scan in both
    packages; deleted, unallocated and allow-masked rows are excluded."""
    X, norms, Q, qn, metric, quantum = _case(kind, n=3000)
    n = X.shape[0]
    rng = np.random.default_rng(5)
    levels = np.zeros(n, np.int32)
    deleted = np.zeros(n, bool)
    allow = None
    if masked:
        levels[rng.random(n) < 0.1] = -1
        deleted[rng.random(n) < 0.1] = True
        allow = rng.random(n) < 0.7
    jd, jr = jscan.scan_search(
        jnp.asarray(X), jnp.asarray(norms), jnp.asarray(levels),
        jnp.asarray(deleted), None if allow is None else jnp.asarray(allow),
        jnp.asarray(Q), jnp.asarray(qn), 10, metric=metric,
        has_allow=allow is not None,
        quantum=None if quantum is None else jnp.float32(quantum))
    td, tr = tscan.scan_search(
        t(X), t(norms), t(levels), t(deleted),
        None if allow is None else t(allow), t(Q), t(qn), 10, metric=metric,
        quantum=None if quantum is None else torch.tensor(quantum))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=RTOL,
                               atol=ATOL)
    if masked:
        ok = (levels >= 0) & ~deleted & allow
        assert ok[tr.numpy()[tr.numpy() >= 0]].all()


def test_scan_topk_matches():
    X, norms, Q, _, metric, _ = _case("l2", n=1500)
    bA, bB = (np.asarray(a) for a in jscan.serving_bias(
        jnp.asarray(X), jnp.asarray(norms), jnp.ones(1500, bool), metric))
    js, jr = jscan.scan_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(bA),
                             jnp.asarray(bB), 10)
    ts, tr = tscan.scan_topk(t(Q), t(X), t(bA), t(bB), 10)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_blocked_scan_more_k_than_rows():
    X, Q = data(6, 8, 1), data(16, 8, 2)
    biasA = (X * X).sum(1)
    jd, jr = jscan._scan_xla(jnp.asarray(Q), jnp.asarray(X),
                             jnp.asarray(biasA), jnp.full((6,), 2.0), 10)
    td, tr = tscan._scan_blocked(t(Q), t(X), t(biasA), torch.full((6,), 2.0),
                                 10)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert (tr[:, 6:] == -1).all()


# (name, kind, fast, exact, bf16-rounded inputs)
FORMS = [("f32_exact", "l2", False, True, False),
         ("int8_sym", "int8_sym", False, False, False),
         ("asym_exact", "int8_asym_l2", False, True, False),
         ("fast", "l2", True, False, True)]


def _pass_a_inputs(kind, round_bf16):
    X, norms, Q, qn, metric, quantum = _case(kind, n=2048, d=32, b=32,
                                             seed=9)
    if round_bf16:
        X = np.asarray(jnp.asarray(X).astype(jnp.bfloat16), np.float32)
        Q = np.asarray(jnp.asarray(Q).astype(jnp.bfloat16), np.float32)
        norms = (X * X).sum(1)
    live = np.random.default_rng(3).random(X.shape[0]) > 0.05
    biasA, biasB = jscan.serving_bias(
        jnp.asarray(X), jnp.asarray(norms), jnp.asarray(live), metric,
        None if quantum is None else jnp.float32(quantum))
    return X, Q, np.asarray(biasA), np.asarray(biasB)


def _tpu_tiles(X, Q, fast, exact):
    hi = jscan._hi_prec_for(jnp.asarray(X).dtype, jnp.asarray(Q).dtype,
                            fast, exact)
    _, st = jscan._tiles(Q.shape[0], X.shape[0], X.dtype == np.int8, hi,
                         dim=X.shape[1])
    return st, min(jscan.g_for(X.shape[0]), st // 128)


@pytest.mark.parametrize("name,kind,fast,exact,rnd", FORMS,
                         ids=[f[0] for f in FORMS])
def test_plain_pass_a_matches_pallas_interpret(name, kind, fast, exact, rnd):
    X, Q, biasA, biasB = _pass_a_inputs(kind, rnd)
    st, g = _tpu_tiles(X, Q, fast, exact)
    jg, ja = jscan._pass_a(jnp.asarray(Q), jnp.asarray(X),
                           jnp.asarray(biasA), jnp.asarray(biasB),
                           interpret=True, fast=fast, exact=exact)
    tg, ta = tscan.pass_a(t(Q), t(X), t(biasA), t(biasB), st=st, g=g,
                          fast=fast, exact=exact)
    assert tuple(tg.shape) == jg.shape and ta.dtype == torch.int32
    np.testing.assert_allclose(np.asarray(jg), tg.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


def test_pass_a_tie_takes_largest_member_and_ragged_edge():
    """Equal scores: the largest member index wins, as in the TPU kernel;
    rows past N (a ragged last tile) score +inf."""
    q = torch.ones((2, 4))
    v = torch.zeros((40, 4))               # every dot is 0
    bA, bB = torch.zeros(40), torch.full((40,), 2.0)
    gmin, garg = tscan.pass_a(q, v, bA, bB, st=16, g=4)
    assert gmin.shape == (2, 12)           # ceil(40/16) tiles x W=4
    assert (gmin == 0).all()
    # tile 2 holds rows 32..39 = members 0 and 1 of its 4 groups
    np.testing.assert_array_equal(garg[:, :8].numpy(), 3)
    np.testing.assert_array_equal(garg[:, 8:].numpy(), 1)


def test_kernel_route_matches_scan_pallas_exact():
    X, Q, biasA, biasB = _pass_a_inputs("l2", False)
    st, g = _tpu_tiles(X, Q, False, True)
    js, jr = jscan._scan_pallas(jnp.asarray(Q), jnp.asarray(X),
                                jnp.asarray(biasA), jnp.asarray(biasB), 10,
                                True, interpret=True)
    ts, tr = tscan._scan_kernel(t(Q), t(X), t(biasA), t(biasB), 10,
                                exact=True, st=st, g=g)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=RTOL,
                               atol=ATOL)


def _exact_scan_taken(*args, **kwargs):
    raise AssertionError("the exact blocked scan ran instead of pass A")


@pytest.mark.parametrize("kind", ["l2", "cos", "int8_asym_l2"])
def test_approx_read_matches_scan_search_pallas(kind, monkeypatch):
    """The serving read on the kernel route (fast pass A for 32
    candidates, exact re-rank by `gathered`, stable sort) against the
    reference's `scan_search` on its Pallas route in interpret mode, both
    at the TPU's tiles. The float inputs are rounded to bf16 first, so the
    fast form's rounding is exact on both sides (CPU JAX runs DEFAULT in
    full f32). Rows equal; distances within RTOL/ATOL (float32 sums in
    another order)."""
    X, norms, Q, qn, metric, quantum = _case(kind, n=2048, d=32, b=32,
                                             seed=13)
    Q = np.asarray(jnp.asarray(Q).astype(jnp.bfloat16), np.float32)
    if X.dtype == np.float32:
        X = np.asarray(jnp.asarray(X).astype(jnp.bfloat16), np.float32)
        if metric == jdist.L2:
            norms = (X * X).sum(1)
    n = X.shape[0]
    rng = np.random.default_rng(21)
    levels = np.where(rng.random(n) < 0.05, -1, 0).astype(np.int32)
    deleted = rng.random(n) < 0.05
    st, g = _tpu_tiles(X, Q, True, False)
    monkeypatch.setattr(jscan, "_use_pallas", lambda n_rows: True)
    monkeypatch.setattr(jscan, "_scan_pallas", functools.partial(
        jscan._scan_pallas, interpret=True))
    monkeypatch.setattr(tscan, "_use_kernel", lambda vectors: True)
    monkeypatch.setattr(tscan, "kernel_tiles", lambda n_rows: (st, g))
    for mod, name in ((jscan, "_scan_xla"), (tscan, "_scan_blocked")):
        monkeypatch.setattr(mod, name, _exact_scan_taken)
    qj = None if quantum is None else jnp.float32(quantum)
    jd, jr = jscan.scan_search.__wrapped__(
        jnp.asarray(X), jnp.asarray(norms), jnp.asarray(levels),
        jnp.asarray(deleted), None, jnp.asarray(Q), jnp.asarray(qn), 32,
        metric=metric, quantum=qj)
    pass_a_calls = tscan.pass_a.launches
    td, tr = tscan.scan_search(
        t(X), t(norms), t(levels), t(deleted), None, t(Q), t(qn), 32,
        metric=metric,
        quantum=None if quantum is None else torch.tensor(quantum))
    assert tscan.pass_a.launches == pass_a_calls      # CPU: plain version
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert (levels[tr.numpy()] >= 0).all() and not deleted[tr.numpy()].any()


def test_kernel_route_all_masked():
    q, v = torch.ones((16, 8)), torch.zeros((1024, 8))
    d, rows = tscan._scan_kernel(q, v, torch.full((1024,), float("inf")),
                                 torch.full((1024,), 2.0), 10)
    assert torch.isinf(d).all() and (rows == -1).all()


def test_gpu_tiles_and_forms():
    for n in (1 << 17, 1 << 20, 1 << 22):
        st, g = tscan.kernel_tiles(n)
        assert g == jscan.g_for(n) and st == 64 * g
    f32, i8, bf = torch.float32, torch.int8, torch.bfloat16
    assert tscan.pass_a_form(f32, f32) == tscan.FORM_F32
    assert tscan.pass_a_form(f32, f32, fast=True) == tscan.FORM_F32_FAST
    assert tscan.pass_a_form(bf, bf) == tscan.FORM_BF16
    assert tscan.pass_a_form(i8, i8) == tscan.FORM_INT8
    assert tscan.pass_a_form(f32, i8, exact=True) == tscan.FORM_ASYM
    assert tscan.pass_a_form(f32, i8) == tscan.FORM_ASYM_FAST
    with pytest.raises(TypeError):
        tscan.pass_a_form(bf, f32)
