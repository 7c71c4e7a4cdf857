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
only on the card (chip_smoke.py holds it against `gathered_plain`)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kektordb_tpu.ops import distance as jdist
from kektordb_tpu_torch.ops import distance as dist

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
