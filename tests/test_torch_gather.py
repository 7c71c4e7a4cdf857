"""The gather-distance step: the port's plain version (`gathered_plain`,
the function of csrc/gather_dist.cu) against the JAX package.

* against `kektordb_tpu.ops.distance.gathered` (its float branch) for f32
  and bf16 arenas, L2 and cosine, with -1 ids: rtol 1e-5 (float32 sums in
  another order), equal +inf positions;
* against `xla_gather_dist` of scripts/pallas_gather2.py, the intended
  function of TPU kernel 5 (its Pallas output has a recorded bug);
* against TPU kernel 4 itself (`pallas_gather_dist` of
  scripts/pallas_gather.py) run in TPU interpret mode with its module's B
  and C set small, within 1e-5 of |q|^2 + |v|^2 + 2|q||v| (the magnitude
  of the terms the L2 expansion cancels).
The scripts are imported by path and not edited. The kernel itself runs
only on the card (chip_smoke.py holds it against `gathered_plain`); here
its wrapper is checked with the library replaced by a recorder: ids
(int32, int64) and queries (f32, bf16) are handed over in place, and
what the kernel does not take is refused. The cold-row probe
(`probes.gather_cold`) is checked for its id sets and bound."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kektordb_tpu.ops import distance as jdist
from kektordb_tpu_torch import native
from kektordb_tpu_torch.ops import distance as dist
from kektordb_tpu_torch.probes import gather_cold

RTOL = 1e-5
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}_under_test", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B, C, N, D, seed, invalid=0.4, normalize=False):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    if normalize:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    ids = rng.integers(0, N, size=(B, C)).astype(np.int32)
    ids[rng.random((B, C)) < invalid] = -1
    return v, q, ids


def _term_tol(q, v, ids):
    """1e-5 of |q|^2 + |v|^2 + 2|q||v| per (query, candidate)."""
    qn = np.linalg.norm(q.astype(np.float32), axis=1)[:, None]
    vn = np.linalg.norm(v.astype(np.float32), axis=1)[np.maximum(ids, 0)]
    return RTOL * (qn + vn) ** 2


@pytest.mark.parametrize("precision,metric", [
    ("float32", "euclidean"), ("float32", "cosine"),
    ("bfloat16", "euclidean"), ("bfloat16", "cosine")])
def test_plain_matches_reference_gathered(precision, metric):
    v, q, ids = _inputs(24, 40, 300, 32, seed=1,
                        normalize=metric == "cosine")
    jdt = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    want = np.asarray(jdist.gathered(jnp.asarray(v).astype(jdt),
                                     jnp.asarray(ids), jnp.asarray(q),
                                     metric))
    vt = torch.from_numpy(v).to(tdt)
    got = dist.gathered_plain(vt, torch.from_numpy(ids),
                              torch.from_numpy(q), metric).numpy()
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    np.testing.assert_array_equal(np.isinf(want), ids < 0)
    fin = ids >= 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)
    # the wrapper takes the plain version for a CPU tensor, no launch
    before = dist.gathered.launches
    again = dist.gathered(vt, torch.from_numpy(ids), torch.from_numpy(q),
                          metric).numpy()
    np.testing.assert_array_equal(again, got)
    assert dist.gathered.launches == before


def test_bf16_query_given_as_bf16_or_f32_agrees():
    """A bf16 arena's dot takes the bf16-rounded query; |q|^2 comes from
    the query as given. A query handed over already in bf16 (the beam's
    encoded query) gives the same as its f32 widening."""
    v, q, ids = _inputs(8, 16, 100, 32, seed=2)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    a = dist.gathered_plain(vt, torch.from_numpy(ids), qb, "euclidean")
    b = dist.gathered_plain(vt, torch.from_numpy(ids), qb.float(),
                            "euclidean")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_matches_kernel5_intended_function():
    """TPU kernel 5 (pallas_gather2) is held to its own `xla_gather_dist`,
    the function it was meant to compute: bf16 arena and query, ids -1 ->
    +inf, 40% of them."""
    mod = _script("pallas_gather2")
    v, q, ids = _inputs(16, 128, 512, 128, seed=3)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    want = np.asarray(mod.xla_gather_dist(jnp.asarray(ids), qb, vb))
    got = dist.gathered_plain(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(ids),
        torch.from_numpy(np.asarray(qb.astype(jnp.float32))),
        "euclidean").numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = ids >= 0
    assert np.all(np.abs(got[fin] - want[fin]) <= _term_tol(q, v, ids)[fin])


def test_plain_matches_kernel4_in_interpret_mode():
    """TPU kernel 4 (pallas_gather) itself, in TPU interpret mode at
    B=16, C=128 (its module constants, set small), N=256, D=128. It takes
    no -1 ids: the -1-free case of the same function."""
    mod = _script("pallas_gather")
    mod.B, mod.C = 16, 128
    v, q, ids = _inputs(16, 128, 256, 128, seed=4, invalid=0.0)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.block_until_ready(
            mod.pallas_gather_dist(jnp.asarray(ids), qb, vb)))
    q_used = np.asarray(qb.astype(jnp.float32))
    got = dist.gathered_plain(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(ids),
        torch.from_numpy(q_used), "euclidean").numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= _term_tol(q_used, v, ids))


def test_cuda_route_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper checks before it launches; on the CPU it is
    reached only directly."""
    v = torch.zeros((8, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        dist._gather_dist(v.to(torch.int8), ids, torch.zeros((2, 4)),
                          "euclidean")
    with pytest.raises(ValueError):
        dist._gather_dist(v, ids, torch.zeros((3, 4)), "euclidean")
    with pytest.raises(ValueError):
        dist._gather_dist(v, ids, torch.zeros((2, 4)), "manhattan")
    with pytest.raises(ValueError):
        dist._gather_dist(v[:, ::2], ids, torch.zeros((2, 2)), "euclidean")
    # the kernel reads ids and queries in place: they must be contiguous,
    # and of a type it reads
    with pytest.raises(ValueError):
        dist._gather_dist(v, torch.zeros((3, 2), dtype=torch.int32).T,
                          torch.zeros((2, 4)), "euclidean")
    with pytest.raises(ValueError):
        dist._gather_dist(v, ids, torch.zeros((4, 2)).T, "euclidean")
    with pytest.raises(TypeError):
        dist._gather_dist(v, ids.to(torch.int16), torch.zeros((2, 4)),
                          "euclidean")
    with pytest.raises(TypeError):
        dist._gather_dist(v, ids.float(), torch.zeros((2, 4)), "euclidean")
    with pytest.raises(TypeError):
        dist._gather_dist(v, ids, torch.zeros((2, 4), dtype=torch.float64),
                          "euclidean")


class _RecordingLib:
    """Stands in for the kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def kektor_gather_dist(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("arena", ["float32", "bfloat16"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idtype", ["int32", "int64"])
def test_cuda_route_reads_ids_and_queries_in_place(monkeypatch, arena, qdtype,
                                                   idtype):
    """The wrapper hands the kernel the caller's own ids and queries (the
    pointers are their data_ptr(): no conversion, no copy) with the dtype
    codes the kernel reads, and counts one launch."""
    lib = _RecordingLib()
    monkeypatch.setattr(native, "load", lambda: lib)
    monkeypatch.setattr(dist, "_stream", lambda device: 77)
    v = torch.zeros((50, 8), dtype=getattr(torch, arena))
    ids = torch.arange(12, dtype=getattr(torch, idtype)).reshape(3, 4)
    q = torch.ones((3, 8), dtype=getattr(torch, qdtype))
    before = dist.gathered.launches
    out = dist._gather_dist(v, ids, q, "cosine")
    assert dist.gathered.launches == before + 1
    assert out.shape == (3, 4) and out.dtype == torch.float32
    (args,) = lib.calls
    code = {"float32": 0, "bfloat16": 1, "int32": 0, "int64": 1}
    assert args == (ids.data_ptr(), code[idtype], q.data_ptr(), code[qdtype],
                    v.data_ptr(), code[arena], out.data_ptr(), 3, 4, 8, 50,
                    1, 77)


@pytest.mark.parametrize("precision,metric", [
    ("float32", "euclidean"), ("float32", "cosine"),
    ("bfloat16", "euclidean"), ("bfloat16", "cosine")])
def test_plain_int64_ids_bf16_queries_match_reference(precision, metric):
    """`gathered_plain` with int64 ids and bf16 queries (as a bf16 index's
    beam hands them over) against the JAX package's `gathered` given the
    same bf16 queries: rtol 1e-5, equal +inf positions."""
    v, q, ids = _inputs(20, 36, 250, 24, seed=5,
                        normalize=metric == "cosine")
    jdt = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    want = np.asarray(jdist.gathered(jnp.asarray(v).astype(jdt),
                                     jnp.asarray(ids), qb, metric))
    got = dist.gathered_plain(
        torch.from_numpy(v).to(tdt), torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(q).to(torch.bfloat16), metric).numpy()
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    np.testing.assert_array_equal(np.isinf(want), ids < 0)
    fin = ids >= 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)


@pytest.mark.parametrize("case", gather_cold.CASES,
                         ids=lambda c: f"{c.name} {c.arena}")
def test_cold_id_sets_leave_four_l2_between_uses(case):
    """Phase 6's timed calls rotate over enough id sets that the rows the
    other sets touch exceed 4x the 50 MB L2 between two uses of one."""
    rb = gather_cold.row_bytes(case.D, case.arena)
    k = gather_cold.n_sets(case.B, case.C, case.N, case.invalid, rb)
    per_set = case.B * case.C * (1 - case.invalid)
    assert 2 <= k < gather_cold.MAX_SETS
    assert gather_cold.touched_bytes(k - 1, per_set, case.N, rb) \
        >= gather_cold.COLD_FACTOR * gather_cold.L2_BYTES


def test_cold_probe_draws_sets_and_times_nothing_on_the_cpu():
    """The probe's id sets have the asked shape, dtype and share of -1;
    its bound counts ids, outputs, queries and the valid rows; on the CPU
    it times nothing."""
    sets = gather_cold.id_sets(64, 32, 1000, 0.4, 256, seed=3,
                               device="cpu", dtype=torch.int64)
    assert len(sets) == gather_cold.MAX_SETS
    for ids in sets:
        assert ids.shape == (64, 32) and ids.dtype == torch.int64
        assert int(ids.max()) < 1000 and int(ids.min()) >= -1
    share = float(torch.stack([(s < 0).double().mean() for s in sets]).mean())
    assert abs(share - 0.4) < 0.02
    valid = sum(int((s >= 0).sum()) for s in sets) / len(sets)
    ms, by = gather_cold.bound_ms(sets, 128, 256, 4)
    assert by == "bytes"
    assert ms == pytest.approx((64 * 32 * 12 + 64 * 128 * 4 + valid * 256)
                               / gather_cold.HBM_BYTES_S * 1e3)
    rows = gather_cold.run("cpu", cases=(
        gather_cold.Case("tiny", 4, 8, 16, 100, "bf16", 0.4),))
    assert rows[0]["case"] == "tiny bf16" and "ms" not in rows[0]
