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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kektordb_tpu.ops import distance as jdist
from kektordb_tpu.ops import quantize as jquant
from kektordb_tpu.ops import scan as jscan
from kektordb_tpu_torch.ops import quantize as tquant
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


# (name, kind, fast, exact, bf16-rounded inputs, D); D=100 is no multiple
# of 16, the tensor-core kernel's depth step (its tail is zero-filled)
FORMS = [("f32_exact", "l2", False, True, False, 32),
         ("int8_sym", "int8_sym", False, False, False, 32),
         ("asym_exact", "int8_asym_l2", False, True, False, 32),
         ("fast", "l2", True, False, True, 32),
         ("fast_d100", "l2", True, False, True, 100),
         ("asym_fast_d100", "int8_asym_l2", False, False, True, 100),
         ("int8_sym_d100", "int8_sym", False, False, False, 100)]


def _pass_a_inputs(kind, round_bf16, d=32):
    X, norms, Q, qn, metric, quantum = _case(kind, n=2048, d=d, b=32,
                                             seed=9)
    if round_bf16:
        Q = np.asarray(jnp.asarray(Q).astype(jnp.bfloat16), np.float32)
        if X.dtype == np.float32:
            X = np.asarray(jnp.asarray(X).astype(jnp.bfloat16), np.float32)
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


@pytest.mark.parametrize("name,kind,fast,exact,rnd,d", FORMS,
                         ids=[f[0] for f in FORMS])
def test_plain_pass_a_matches_pallas_interpret(name, kind, fast, exact, rnd,
                                               d):
    X, Q, biasA, biasB = _pass_a_inputs(kind, rnd, d)
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


def _dup_case(seed=0):
    """512 random rows of d=32, each repeated 4x (`np.repeat`), and 32
    queries: at the TPU's tiles (ST=2048, G=8, W=256) the four copies sit
    in four neighbouring groups with the same members, so gmin holds runs
    of four equal values at neighbouring positions (distinct rows at
    equal distance, the deduplication traffic)."""
    rng = np.random.default_rng(seed)
    X = np.repeat(rng.normal(size=(512, 32)).astype(np.float32), 4, axis=0)
    Q = rng.normal(size=(32, 32)).astype(np.float32)
    return X, Q


@pytest.mark.parametrize("k", [8, 10])
def test_kernel_route_ties_match_scan_pallas_exact(k):
    """Pass B on tied scores returns `lax.top_k`'s members and order:
    lower position first. At k=8 the last place ends a run of four ties;
    at k=10 it falls inside one, so which of the tied rows win matters."""
    X, Q = _dup_case()
    bA, bB = (np.asarray(a) for a in jscan.serving_bias(
        jnp.asarray(X), jnp.asarray((X * X).sum(1)), jnp.ones(2048, bool),
        jdist.L2))
    js, jr = jscan._scan_pallas(jnp.asarray(Q), jnp.asarray(X),
                                jnp.asarray(bA), jnp.asarray(bB), k, True,
                                interpret=True)
    ts, tr = tscan._scan_kernel(t(Q), t(X), t(bA), t(bB), k, exact=True,
                                st=2048, g=8)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_pass_b_matches_stable_sort(k):
    """pass_b against the reference's pass B, `lax.top_k(-gmin, k)`, and
    against a stable sort of the whole row, on small-integer values (many
    ties everywhere) with some +inf; rows with a run of ties across the
    k-th place are rebuilt, the others only reordered."""
    rng = np.random.default_rng(k)
    g = rng.integers(0, 6, size=(64, 40)).astype(np.float32)
    g[rng.random(g.shape) < 0.1] = np.inf
    bd, bp = tscan.pass_b(torch.from_numpy(g), k)
    neg, top = jax.lax.top_k(-jnp.asarray(g), k)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(top))
    np.testing.assert_array_equal(bd.numpy(), -np.asarray(neg))
    order = np.argsort(g, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(bp.numpy(), order)
    np.testing.assert_array_equal(bd.numpy(),
                                  np.take_along_axis(g, order, 1))


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
    _approx_read_both(monkeypatch, X, norms, Q, qn, metric, quantum)


def test_approx_read_ties_match_scan_search_pallas(monkeypatch):
    """The same read on the duplicated rows of `_dup_case`: pass B's
    candidates on tied scores, then the re-rank's stable sort, give the
    reference's rows. The reference's pass B is taken in its exact form
    (`lax.top_k`): the port's pass B is always exact, and the order that
    `approx_min_k` gives tied scores is its implementation's (on the CPU
    an unstable sort)."""
    X, Q = _dup_case(seed=4)
    _approx_read_both(monkeypatch, X, (X * X).sum(1), Q,
                      np.zeros(Q.shape[0], np.float32), jdist.L2, None,
                      exact_pass_b=True)


def _approx_read_both(monkeypatch, X, norms, Q, qn, metric, quantum,
                      exact_pass_b=False):
    """Both packages' `scan_search` (approx mode, kernel route, k=32) on
    the same inputs, a twentieth of the rows unallocated or deleted:
    rows equal, distances within RTOL/ATOL. `exact_pass_b`: the
    reference's pass B is `lax.top_k` (its exact mode) while its pass A
    stays in the fast form."""
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
    pallas = functools.partial(jscan._scan_pallas, interpret=True)
    if exact_pass_b:
        def pallas(q, v, bA, bB, k, exact, _ref=jscan._scan_pallas, **kw):
            return _ref(q, v, bA, bB, k, True, interpret=True, **kw)
    monkeypatch.setattr(jscan, "_scan_pallas", pallas)
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


@pytest.mark.parametrize("form", range(6))
def test_form_kernel_route(form, monkeypatch):
    """Every form runs on the one tensor-core kernel, by its own product:
    3xTF32 for f32 exact, three bf16 pieces of the query for asym exact,
    one exact s8 product for int8 x int8, one bf16 product for the rest;
    only the bf16 form takes a transposed arena (the others are refused
    before the library loads)."""
    want = {tscan.FORM_F32: ("tf32", 3), tscan.FORM_ASYM: ("bf16", 3),
            tscan.FORM_INT8: ("int8", 1)}.get(form, ("bf16", 1))
    assert tscan.FORM_PRODUCTS[form] == want

    class Loaded(Exception):
        pass

    def load():
        raise Loaded
    monkeypatch.setattr(tscan.native, "load", load)
    qd, vd = tscan.FORM_DTYPES[form]
    q, vT = torch.zeros((4, 8), dtype=qd), torch.zeros((8, 64), dtype=vd)
    with pytest.raises(Loaded if form == tscan.FORM_BF16 else ValueError):
        tscan.launch_pass_a(q, vT, torch.zeros(64), None, st=32, g=4,
                            form=form, transposed=True)


def test_form_dtypes_follow_pass_a_form():
    for form, (qd, vd) in tscan.FORM_DTYPES.items():
        fast = form in (tscan.FORM_F32_FAST,)
        exact = form in (tscan.FORM_F32, tscan.FORM_ASYM)
        assert tscan.pass_a_form(qd, vd, fast=fast, exact=exact) == form
    with pytest.raises(TypeError):
        tscan.pass_a_form(torch.bfloat16, torch.int8)


def _operands(B=4, N=64, D=8, qd=torch.float32, vd=torch.float32):
    return (torch.zeros((B, D), dtype=qd), torch.zeros((N, D), dtype=vd),
            torch.zeros(N), torch.full((N,), 2.0))


# (name, change to the operands or keywords, error) for launch_pass_a's
# checks, all made in Python before the library is loaded
LAUNCH_RULES = [
    ("form_dtype", dict(form=tscan.FORM_BF16), TypeError),
    ("arena_dtype", dict(v=torch.zeros((64, 8), dtype=torch.int8)),
     TypeError),
    ("depth_mismatch", dict(v=torch.zeros((64, 9))), ValueError),
    ("query_1d", dict(q=torch.zeros(8)), ValueError),
    ("bias_shape", dict(bA=torch.zeros(63)), ValueError),
    ("bias_dtype", dict(bB=torch.full((64,), 2.0, dtype=torch.float64)),
     ValueError),
    ("st_not_multiple_of_g", dict(st=30, g=4), ValueError),
    ("arena_not_contiguous", dict(v=torch.zeros((8, 64)).T), ValueError),
    ("transposed_f32", dict(transposed=True, v=torch.zeros((8, 64)),
                            bB=None), ValueError),
    ("unknown_form", dict(form=7), ValueError),
]


@pytest.mark.parametrize("name,change,err", LAUNCH_RULES,
                         ids=[r[0] for r in LAUNCH_RULES])
def test_launch_pass_a_shape_rules(name, change, err, monkeypatch):
    def no_library():
        raise AssertionError("the checks let a bad launch through")
    monkeypatch.setattr(tscan.native, "load", no_library)
    q, v, bA, bB = _operands()
    kw = dict(q=q, v=v, bA=bA, bB=bB, st=32, g=4, form=tscan.FORM_F32_FAST,
              transposed=False)
    kw.update(change)
    with pytest.raises(err):
        tscan.launch_pass_a(kw["q"], kw["v"], kw["bA"], kw["bB"],
                            st=kw["st"], g=kw["g"], form=kw["form"],
                            transposed=kw["transposed"])


def _tf32_big(x):
    """x with its low 13 mantissa bits cleared (the kernel's `big`)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_rna(x):
    """x rounded to tf32, half away from zero (`cvt.rna.tf32.f32`)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_dots(q, v, form):
    """The dots of exact forms 0 and 4 as csrc/scan_pass_a_wgmma.cu forms
    them, each product exact and summed in f32: form 0 is 3xTF32 (big.big
    + big.small + small.big, small = x - big rounded to tf32); form 4
    splits the query into three bf16 pieces times the codes (exact in
    bf16)."""
    if form == tscan.FORM_F32:
        qb, vb = _tf32_big(q), _tf32_big(v)
        qs, vs = _tf32_rna(q - qb), _tf32_rna(v - vb)
        return qs @ vb.T + qb @ vs.T + qb @ vb.T
    pieces, r = [], q
    for _ in range(3):
        pieces.append(r.to(torch.bfloat16).float())
        r = r - pieces[-1]
    return sum(p @ v.float().T for p in reversed(pieces))


def _sift_like(n, d, seed):
    """Byte-range clustered rows, the scale of the SIFT-like serving data."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 160.0, size=(64, d))
    noise = rng.gamma(2.0, 1.0, size=(n, d)) * rng.choice([-1.0, 1.0],
                                                           size=(n, d))
    x = centers[rng.integers(0, 64, size=n)] + 11.0 * noise
    return np.clip(x, 0.0, 255.0).astype(np.float32)


@pytest.mark.parametrize("form", ["f32", "asym"])
def test_exact_form_split_within_phase3_tolerance(form):
    """Kernel B's split arithmetic, emulated in torch on the CPU (tf32 by
    bit masks, the bf16 pieces by casts), against the full-f32 plain
    version at the serving scale (SIFT-like byte-range rows, D=128; unit
    queries against cosine int8 codes): every score within the tolerance
    chip_smoke.py's phase 3 holds the kernel to, RTOL 1e-5 of
    max|biasA| + max|biasB| max|q| max|v|. One tf32 or bf16 pass alone
    falls outside it, so the split's terms are what keep it inside. This
    pins the split's error budget; it runs neither the kernel nor the JAX
    package (chip_smoke.py holds the kernel to the plain version)."""
    X = torch.from_numpy(_sift_like(4096 + 64, 128, seed=31))
    v, q = X[:4096], X[4096:]
    if form == "f32":
        fid = tscan.FORM_F32
        bA = (v * v).sum(1)
        bB = torch.full_like(bA, 2.0)
        one_pass = _tf32_big(q) @ _tf32_big(v).T
    else:
        fid = tscan.FORM_ASYM
        v, norms = tquant.quantize_rowwise(v / v.norm(dim=1, keepdim=True))
        q = q / q.norm(dim=1, keepdim=True)
        bA, bB = torch.zeros(4096), 2.0 / norms
        one_pass = q.to(torch.bfloat16).float() @ v.float().T
    plain = bA - tscan._form_dots(q, v, fid) * bB
    split = bA - _split_dots(q, v, fid) * bB
    tol = RTOL * (float(bA.abs().max()) + float(bB.abs().max())
                  * float(q.float().norm(dim=1).max())
                  * float(v.float().norm(dim=1).max()))
    assert float((split - plain).abs().max()) <= tol
    assert float(((bA - one_pass * bB) - plain).abs().max()) > tol
