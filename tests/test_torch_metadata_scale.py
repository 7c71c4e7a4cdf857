"""The port's metadata store at scale (engine/metadata.py, the JAX
package's tests/test_metadata_scale.py): the incremental NumericColumn
(base + pending + dead), selective update(), batch ingest, the columnar
decay factors.

* The reference's seven cases run against the port (its source read,
  every `kektordb_tpu` module made the port's); its 100k-row case is
  marked slow there and stays so (it gates wall-clock seconds).
* The same seeded operations go through both packages' MetadataStore and
  NumericColumn: the same rows for every range and term, the same stored
  metadata, the same decay factors; once at 100,000 rows (the slow
  case's size, without its clock).
"""

import time

import numpy as np
import pytest
from test_torch_port_reference import reference_cases

from kektordb_tpu.engine import fusion as jfusion
from kektordb_tpu.engine import metadata as jmeta
from kektordb_tpu_torch.engine import fusion as tfusion
from kektordb_tpu_torch.engine import metadata as tmeta

exec(compile(reference_cases("test_metadata_scale.py"),
             "test_metadata_scale.py", "exec"))

TERMS = (("grp", "=", "3"), ("grp", "!=", "2"), ("score", ">", "0.5"),
         ("score", "<=", "-0.25"), ("name", "=", "n7"), ("flag", "=", "true"))


def _store_ops(meta, seed: int, n: int) -> tuple:
    """Seeded set_batch, set, update and remove on one MetadataStore;
    what its columns answer afterwards."""
    rng = np.random.default_rng(seed)
    ms = meta.MetadataStore()
    metas = [{"grp": int(rng.integers(0, 7)), "score": float(rng.normal()),
              "name": f"n{int(rng.integers(0, 13))}",
              "flag": bool(rng.integers(0, 2))} for _ in range(n)]
    ms.set_batch(range(n), metas)
    for r in rng.integers(0, n, size=n // 10).tolist():
        ms.set(r, {"grp": int(rng.integers(0, 7)), "name": "n7"})
    for r in rng.integers(0, n, size=n // 10).tolist():
        ms.update(r, {"score": float(rng.normal())})
    for r in rng.integers(0, n, size=n // 20).tolist():
        ms.remove(r)
    live = np.ones(n + 16, bool)
    masks = [ms.eval_term_mask(*t, live).tolist() for t in TERMS]
    ranges = [sorted(int(x) for x in ms.numeric["score"].range_rows(op, v))
              for op, v in (("<", 0.0), (">=", 1.0), (">", -2.0))]
    rows = rng.integers(0, n, size=200).tolist()
    return masks, ranges, [ms.get(r) for r in rows]


@pytest.mark.parametrize("seed,n", [(0, 2000), (1, 2000), (2, 100_000)],
                         ids=["2k-0", "2k-1", "100k"])
def test_store_agrees_with_reference(seed, n):
    assert _store_ops(tmeta, seed, n) == _store_ops(jmeta, seed, n)


def _column_ops(meta, seed: int) -> list:
    """NumericColumn: interleaved set, set_batch and remove across its
    merges; the rows of every range after each round."""
    rng = np.random.default_rng(seed)
    col = meta.NumericColumn()
    out = []
    for _ in range(5):
        rows = rng.integers(0, 4000, size=1200)
        col.set_batch(rows[:600].tolist(), rng.normal(size=600).tolist())
        for r, v in zip(rows[600:].tolist(), rng.normal(size=600).tolist()):
            col.set(r, v)
        for r in rng.integers(0, 4000, size=150).tolist():
            col.remove(r)
        pivot = float(rng.normal())
        out.append([sorted(int(x) for x in col.range_rows(op, pivot))
                    for op in ("<", "<=", ">", ">=")])
    return out


def test_numeric_column_agrees_with_reference():
    assert _column_ops(tmeta, 5) == _column_ops(jmeta, 5)


def test_decay_factors_agree_with_reference():
    now = time.time()
    rng = np.random.default_rng(3)
    layers = ("episodic", "semantic", None)
    metas = [{"_created_at": now - float(rng.uniform(0, 40 * 86400)),
              "_access_count": int(rng.integers(0, 9)),
              **({"_memory_layer": layers[i % 3]} if layers[i % 3] else {}),
              **({"_last_accessed": now - 60.0} if i % 5 == 0 else {}),
              **({"_pinned": True} if i % 11 == 0 else {})}
             for i in range(500)]
    rows = rng.integers(-1, 520, size=(16, 40))
    got = []
    for meta, fusion in ((tmeta, tfusion), (jmeta, jfusion)):
        cfg = fusion.MemoryConfig(
            enabled=True, decay_half_life=86400.0,
            layers={"episodic": fusion.LayerConfig(
                        decay_half_life=3600.0, decay_model="ebbinghaus"),
                    "semantic": fusion.LayerConfig(decay_model="step")})
        ms = meta.MetadataStore()
        ms.set_batch(range(len(metas)), metas)
        got.append(fusion.decay_factors(ms.decay, rows, cfg, now))
    np.testing.assert_allclose(got[0], got[1], rtol=1e-12)
