"""The port's hit emission against the JAX package's, bit for bit.

`Engine._assemble_fast` (the plain read: min-max scores over every
candidate fetched, then each query's first k hits) and `Engine._emit_topk`
(the fused reads' ranked top-k) are called unbound on the port's handle
and index, once as the JAX package writes them and once as the port does,
with the same arrays. Every form of the answer must be equal: the ids,
the float bits, the rounding, dict key order, and list or ndarray types.
The grid: columnar False / True / "np", metadata off / on, and four
inputs: every candidate live (rectangular); a deleted row among the first
k; k candidates fetched of 8, -1 padded, one query with fewer than k; a
filter that matches nothing (every row -1). The fused form of the first
and the third holds a text-only hit (distance +inf)."""

import struct

import numpy as np
import pytest

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu_torch.engine import Engine, EngineConfig

N, DIM, B, K, F = 40, 8, 4, 5, 8
DELETED = 7


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(3)
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    e.create_index("c", kind="flat")
    # odd rows carry no metadata: they emit {}
    e.add_batch("c", [f"v{i}" for i in range(N)],
                rng.normal(size=(N, DIM)).astype(np.float32),
                [{"i": i} if i % 2 == 0 else None for i in range(N)])
    e.delete("c", f"v{DELETED}")
    yield e
    e.close()


def candidates(case):
    """(d [B, F] f32 ascending, rows [B, F] int64) as a scan returns
    them: +inf / -1 where a query has no more candidates."""
    rng = np.random.default_rng(11)
    live = np.array([r for r in range(N) if r != DELETED])
    rows = np.stack([rng.choice(live, F, replace=False) for _ in range(B)])
    d = np.sort(rng.uniform(0.5, 4.0, (B, F)).astype(np.float32), 1)
    if case == "deleted":
        rows[1, 2] = DELETED
    elif case == "padded":
        rows[:, K:] = -1
        rows[2, 3:] = -1
        d[1, :] = d[1, 0]                    # equal distances: scores 1
    elif case == "nothing":
        rows[:] = -1
    d = np.where(rows >= 0, d, np.inf).astype(np.float32)
    return d, rows.astype(np.int64)


def fused(case, d, rows):
    """The fused reads' (scores, rows, distances) [B, K]: min-max scores,
    -inf where no candidate; float32 as the device epilogue gives them,
    float64 as the host path does."""
    valid = rows >= 0
    dm = np.where(valid.any(1, keepdims=True),
                  np.where(valid, d, np.nan), 0.0)
    with np.errstate(invalid="ignore"):
        lo = np.nanmin(dm, 1, keepdims=True)
        hi = np.nanmax(dm, 1, keepdims=True)
    span = hi - lo
    sc = np.where(span > 0, (hi - d) / np.where(span > 0, span, 1.0), 1.0)
    sc = np.where(valid, sc, -np.inf)[:, :K]
    top_d = d[:, :K].copy()
    if case in ("rect", "padded"):
        top_d[0, 3] = np.inf                 # a text-only hit
    dt = np.float32 if case in ("rect", "deleted") else np.float64
    return sc.astype(dt), rows[:, :K], top_d.astype(dt)


def same(a, b):
    """Equal in type, keys and their order, and every float's bits."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            same(a[key], b[key])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, float):
        assert struct.pack("<d", a) == struct.pack("<d", b), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("case", ["rect", "deleted", "padded", "nothing"])
@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("columnar", [False, True, "np"])
@pytest.mark.parametrize("emitter", ["_assemble_fast", "_emit_topk"])
def test_the_port_emits_the_reference_hits(engine, emitter, columnar, meta,
                                           case):
    h = engine.indexes["c"]
    d, rows = candidates(case)
    arrays = (d, rows) if emitter == "_assemble_fast" \
        else fused(case, d, rows)
    want = getattr(JEngine, emitter)(engine, h, h.index, *arrays, B, K,
                                     meta, columnar)
    got = getattr(Engine, emitter)(engine, h, h.index, *arrays, B, K,
                                   meta, columnar)
    same(got, want)
    # the plain read fills a deleted row's place from its later
    # candidates; the fused top-k has none
    n = [len(x) for x in (got["ids"] if columnar else got)]
    assert n == {"rect": [K] * B, "padded": [K, K, 3, K], "nothing": [0] * B,
                 "deleted": [K, K if emitter == "_assemble_fast" else K - 1,
                             K, K]}[case]
