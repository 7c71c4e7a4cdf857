"""The port's sharded index (kektordb_tpu_torch/parallel/sharded.py) held
to the JAX package's ShardedHNSW.

The reference runs on the 8 virtual CPU devices of tests/conftest.py;
the port on the CPU repeated 8 times (the device-repeat setting,
KEKTOR_TORCH_DEVICE_REPEAT, set by this module's fixture, or an explicit
device list). Both packages are given the same seeded rows in the same
order, so both route every id to the same shard and local row.

* Exact reads (the scan on the CPU is exact in both packages, and
  `scan_exact` everywhere): the same (shard, row) pairs and global rows,
  in the same order, tie order included: rows repeated on several shards
  tie at the merge, and the lower shard comes first in both. Distances
  within rtol 1e-5, atol 1e-4 (float32 sums in another order).
* Approximate reads (the beam): recall@10 against BruteForceIndex at the
  reference's floor (0.85), and overlap with the reference's hits >= 0.9.
* One sharded state carried across (`ShardedHNSW.from_reference_state`,
  and a checkpoint written by either package) gives the same exact rows.
* The cases of tests/test_sharded.py, each on the port: recall, shard
  balance, delete, streaming add, the Engine (filters, hybrid text,
  checkpoint, journal replay), filtered scan and beam, the one build
  program per chunk against the per-shard loop, the shared int8
  quantizer, per-shard residency and capacity, the checkpoint's downgrade
  on a smaller host, and the projected scan with one shared basis.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_native import private_reference_native

from kektordb_tpu.index import HNSWConfig as JConfig
from kektordb_tpu.parallel import ShardedHNSW as JSharded
from kektordb_tpu.parallel import make_mesh as jmake_mesh
from kektordb_tpu.persist import checkpoint as jckpt
from kektordb_tpu.persist import index_io as jio
from kektordb_tpu_torch import device as devlib
from kektordb_tpu_torch.index import BruteForceIndex, HNSWConfig, HNSWIndex
from kektordb_tpu_torch.ops import distance as dist
from kektordb_tpu_torch.parallel import ShardedHNSW, make_mesh
from kektordb_tpu_torch.parallel.sharded import _route
from kektordb_tpu_torch.persist import checkpoint, index_io

RTOL, ATOL = 1e-5, 1e-4
CFG = dict(m=8, ef_construction=64, ef_search=64, chunk=256)


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's replay scans on its C++ library, built for this
    module alone."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


@pytest.fixture(autouse=True, scope="module")
def eight_devices():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(devlib.DEVICE_REPEAT_ENV, "8")
        yield


def cpu(n):
    return [torch.device("cpu")] * n


@pytest.fixture(scope="module")
def pair():
    """(reference, port, oracle, X): 4000 x 24 L2 rows on 8 shards, the
    default serve mode (graph build, scan serving), in both packages."""
    assert len(jax.devices()) >= 8
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4000, 24)).astype(np.float32)
    ids = [f"v{i}" for i in range(4000)]
    ref = JSharded(24, "euclidean", config=JConfig(**CFG),
                   mesh=jmake_mesh(8))
    ref.add_batch(ids, X)
    port = ShardedHNSW(24, dist.L2, config=HNSWConfig(**CFG),
                       mesh=make_mesh(8, "cpu"))
    port.add_batch(ids, X)
    oracle = BruteForceIndex(24, dist.L2, device="cpu")
    oracle.add_batch(ids, X)
    return ref, port, oracle, X


def recall(hits, gi, n=10):
    B = len(hits)
    return sum(len({f"v{int(r)}" for r in gi[b] if r >= 0}
                   & {h[0] for h in hits[b]}) for b in range(B)) / (B * n)


def overlap(a, b):
    return np.mean([len({h[0] for h in x} & {h[0] for h in y})
                    / max(len(x), 1) for x, y in zip(a, b)])


def same_raw(ref_raw, port_raw):
    (dj, sj, rj), (dt, st, rt) = ref_raw, port_raw
    np.testing.assert_array_equal(np.asarray(sj)[np.asarray(rj) >= 0],
                                  st[rt >= 0])
    np.testing.assert_array_equal(np.asarray(rj), rt)
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=RTOL, atol=ATOL)


# -- the cases of tests/test_sharded.py, on the port ----------------------

def test_sharded_recall(pair):
    ref, port, oracle, X = pair
    Q = np.random.default_rng(1).normal(size=(64, 24)).astype(np.float32)
    _, gi = oracle.search(Q, 10)
    hits = port.search_ids(Q, 10)
    assert recall(hits, gi) >= 0.9
    assert hits == ref.search_ids(Q, 10) or \
        overlap(hits, ref.search_ids(Q, 10)) >= 0.99


def test_shard_distribution(pair):
    ref, port, _, _ = pair
    sizes = [len(s) for s in port.shards]
    assert sizes == [len(s) for s in ref.shards]
    assert sum(sizes) == 4000 and min(sizes) > 0


def test_sharded_delete(pair):
    ref, port, oracle, X = pair
    for idx in (ref, port):
        assert idx.delete("v7")
        assert idx.search_ids(X[7][None], 1)[0][0][0] != "v7"
        assert not idx.delete("v7")
    assert port.search_ids(X[7][None], 3) == ref.search_ids(X[7][None], 3) \
        or overlap(port.search_ids(X[7][None], 3),
                   ref.search_ids(X[7][None], 3)) == 1.0


def test_sharded_streaming_add(pair):
    ref, port, _, X = pair
    v = X[0] * 0.5 + 10.0
    for idx in (ref, port):
        idx.add("fresh1", v)
        assert idx.search_ids(v[None], 1)[0][0][0] == "fresh1"
    assert port.ids.get("fresh1") == ref.ids.get("fresh1")


class TestEngineSharded:
    """A sharded index through the Engine (create_index(shards=N)):
    filters and metadata by global rows, hybrid text, a checkpoint and a
    journal replay that come back sharded."""

    def test_engine_sharded_lifecycle(self, tmp_path):
        from kektordb_tpu.engine import Engine as JEngine
        from kektordb_tpu.engine import EngineConfig as JEngineConfig
        from kektordb_tpu_torch.engine import Engine, EngineConfig
        rng = np.random.default_rng(3)
        X = rng.normal(size=(800, 16)).astype(np.float32)
        e = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                                start_background=False)).open()
        j = JEngine(JEngineConfig(start_background=False)).open()
        for eng in (e, j):
            eng.create_index("sh", m=8, shards=8)
            eng.add_batch("sh", [f"v{i}" for i in range(800)], X,
                          metadatas=[{"grp": i % 4} for i in range(800)])
        assert isinstance(e.indexes["sh"].index, ShardedHNSW)
        assert e.index_info("sh")["shards"] == 8
        assert e.search("sh", X[17], k=1)[0][0]["id"] == "v17"
        hits = e.search("sh", X[20], k=5, filter="grp = 0",
                        include_metadata=True)[0]
        assert hits and all(h["metadata"]["grp"] == 0 for h in hits)
        assert hits[0]["id"] == "v20"
        want = j.search("sh", X[20], k=5, filter="grp = 0")[0]
        assert [h["id"] for h in hits] == [h["id"] for h in want]
        assert e.delete("sh", "v17")
        assert e.search("sh", X[17], k=1)[0][0]["id"] != "v17"
        e.add("sh", "fresh", X[0] + 30.0, {"grp": 9})
        assert e.search("sh", X[0] + 30.0, k=1)[0][0]["id"] == "fresh"
        e.save_snapshot()
        e.close()
        j.close()
        e2 = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                                 start_background=False)).open()
        idx2 = e2.indexes["sh"].index
        assert isinstance(idx2, ShardedHNSW) and len(idx2) == 800
        assert e2.search("sh", X[0] + 30.0, k=1)[0][0]["id"] == "fresh"
        h2 = e2.search("sh", X[20], k=5, filter="grp = 0")[0]
        assert h2 and h2[0]["id"] == "v20"
        e2.close()

    def test_engine_sharded_hybrid_text(self):
        from kektordb_tpu_torch.engine import Engine, EngineConfig
        rng = np.random.default_rng(7)
        X = rng.normal(size=(200, 16)).astype(np.float32)
        e = Engine(EngineConfig(device="cpu",
                                start_background=False)).open()
        e.create_index("sh", m=8, shards=4)
        e.add_batch("sh", [f"v{i}" for i in range(200)], X,
                    metadatas=[{"body": "alpha doc" if i < 100
                                else "beta doc",
                                "_indexed_fields": ["body"],
                                "par": i % 2} for i in range(200)])
        hits = e.search("sh", X[3], k=3, text_query="alpha", alpha=0.5)[0]
        assert hits[0]["id"] == "v3"
        hits = e.search("sh", X[150], k=3, text_query="beta",
                        alpha=0.5)[0]
        assert hits[0]["id"] == "v150"
        hits = e.search("sh", X[4], k=3, filter="par = 0",
                        text_query="alpha", alpha=0.5)[0]
        assert hits[0]["id"] == "v4"
        assert all(int(h["id"][1:]) % 2 == 0 for h in hits)
        hits = e.search("sh", np.zeros(16, np.float32), k=5,
                        text_query="beta")[0]
        assert hits and all(int(h["id"][1:]) >= 100 for h in hits)
        e.close()

    def test_engine_sharded_aof_replay(self, tmp_path):
        from kektordb_tpu_torch.engine import Engine, EngineConfig
        rng = np.random.default_rng(4)
        X = rng.normal(size=(64, 8)).astype(np.float32)
        e = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                                start_background=False)).open()
        e.create_index("sh", m=4, shards=4)
        e.add_batch("sh", [f"v{i}" for i in range(64)], X)
        e._aof.flush(fsync=True)
        e._aof.close()          # a crash: no snapshot
        e2 = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                                 start_background=False)).open()
        idx2 = e2.indexes["sh"].index
        assert isinstance(idx2, ShardedHNSW) and idx2.n_shards == 4
        assert e2.search("sh", X[5], k=1)[0][0]["id"] == "v5"
        e2.close()


def test_sharded_scan_filtered(pair):
    ref, port, oracle, X = pair
    allow = np.zeros(port._cap, bool)
    gids = [port.ids.ext_to_row[f"v{i}"] for i in range(0, 4000, 10)
            if f"v{i}" in port.ids]
    allow[gids] = True
    d, rows = port.search(X[:8], 5, allow_rows=allow)
    assert all(int(r) in set(gids) or r < 0 for r in rows.ravel())
    jallow = np.zeros(ref._cap, bool)
    jallow[gids] = True
    same_raw(ref._search_raw(X[:8], 5, allow_rows=jallow),
             port._search_raw(X[:8], 5, allow_rows=allow))


def test_mesh_residency(pair):
    """Each shard's tensors live on its own mesh device; a search changes
    no shard's state version (nothing is rebuilt per query); a write
    changes only the shard it lands on."""
    _, port, _, X = pair
    for s, dev in zip(port.shards, port.mesh):
        assert all(t.device == dev for t in s.state)
    before = [s._version for s in port.shards]
    port.search(X[:4], 3)
    allow = np.zeros(port._cap, bool)
    allow[: len(port.ids)] = True
    port.search(X[:4], 3, allow_rows=allow)
    assert [s._version for s in port.shards] == before
    port.add("resident-probe", X[0] + 50.0)
    port.search(X[:4], 3)
    moved = [a != b for a, b in
             zip(before, [s._version for s in port.shards])]
    assert moved.count(True) == 1
    assert moved.index(True) == _route("resident-probe") % 8


def test_spmd_build_matches_sequential():
    """The chunk-step build (every shard inserts its chunk per step) and
    the per-shard loop give the same shard sizes and beam recall."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(1200, 16)).astype(np.float32)
    ids = [f"v{i}" for i in range(1200)]
    cfg = dict(m=8, ef_construction=48, ef_search=48, chunk=128, intra_k=8)
    spmd = ShardedHNSW(16, dist.L2, config=HNSWConfig(**cfg), mesh=cpu(4))
    spmd.add_batch(ids, X)
    seq = ShardedHNSW(16, dist.L2, config=HNSWConfig(**cfg), mesh=cpu(4))
    for s, bidx in enumerate([[j for j in range(1200)
                               if _route(ids[j]) % 4 == s]
                              for s in range(4)]):
        block = [ids[j] for j in bidx]
        seq.shards[s].add_batch(block, X[bidx])
        for e in block:
            seq._register(e, s)
    assert [len(s) for s in spmd.shards] == [len(s) for s in seq.shards]
    oracle = BruteForceIndex(16, dist.L2, device="cpu")
    oracle.add_batch(ids, X)
    Q = rng.normal(size=(32, 16)).astype(np.float32)
    _, gi = oracle.search(Q, 10)
    for idx in (spmd, seq):
        assert recall(idx.search_ids(Q, 10, mode="beam"), gi) >= 0.85


def test_spmd_build_int8_shared_quantizer():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(600, 16)).astype(np.float32)
    ids = [f"v{i}" for i in range(600)]
    cfg = dict(m=8, ef_construction=48, ef_search=48, chunk=128, intra_k=8)
    sh = ShardedHNSW(16, dist.COSINE, dist.INT8, config=HNSWConfig(**cfg),
                     mesh=cpu(4))
    sh.add_batch(ids, X)
    scales = {float(s.quantizer.abs_max) for s in sh.shards}
    assert len(scales) == 1, "shards must share ONE quantizer scale"
    ref = JSharded(16, "cosine", "int8", config=JConfig(**cfg),
                   mesh=jmake_mesh(4))
    ref.add_batch(ids, X)
    # the reference's scale, to 1 ulp (the rows are normalised first, the
    # norm summed in another order)
    np.testing.assert_allclose(scales.pop(),
                               float(ref.shards[0].quantizer.abs_max),
                               rtol=2e-7)
    hits = sh.search_ids(X[:16], 1)
    assert sum(h[0][0] == f"v{i}" for i, h in enumerate(hits)) >= 14
    # the int8 codes are the reference's, shard for shard
    for s, r in zip(sh.shards, ref.shards):
        n = s.ids.capacity_used
        np.testing.assert_array_equal(
            s.state.vectors[:n].numpy(), np.asarray(r.state.vectors)[:n])


def test_capacity_scales_linearly_with_devices(pair):
    """Each device holds only its own ~N/S rows: the per-shard bytes add
    up to the index's, and no shard holds more than twice its share."""
    _, port, _, _ = pair
    n = len(port)
    sizes = np.array([len(s) for s in port.shards])
    assert sizes.sum() == n
    assert sizes.max() <= 2 * (n / port.n_shards)
    rep = port.memory_report()
    assert rep["shards"] == port.n_shards
    assert rep["per_shard_bytes"] == [
        s.memory_report()["device_bytes"] for s in port.shards]
    assert rep["device_bytes"] == sum(rep["per_shard_bytes"])
    assert rep["rows_used"] == n and rep["capacity_rows"] >= n
    for s in port.shards:                  # each shard its own capacity
        assert s.memory_report()["capacity_rows"] == s._cap >= len(s)


def test_sharded_checkpoint_degrades_on_smaller_host():
    rng = np.random.default_rng(13)
    X = rng.normal(size=(300, 12)).astype(np.float32)
    sh = ShardedHNSW(12, dist.L2,
                     config=HNSWConfig(m=8, ef_construction=48,
                                       ef_search=48, chunk=128),
                     mesh=cpu(4))
    sh.add_batch([f"v{i}" for i in range(300)], X)
    arrays: dict = {}
    st = index_io.dump_index(sh, "idx", arrays)
    st["n_shards"] = 99          # as if saved on 99 devices
    idx2 = index_io.load_index(st, arrays, "idx", device="cpu")
    assert isinstance(idx2, HNSWIndex) and len(idx2) == 300
    hits = idx2.search_ids(X[:8], 1)
    assert all(h[0][0] == f"v{i}" for i, h in enumerate(hits))


def test_sharded_filtered_beam_low_selectivity(pair):
    _, port, oracle, X = pair
    sel = [i for i in range(0, 4000, 25) if f"v{i}" in port.ids]
    allow = np.zeros(port._cap, bool)
    allow[[port.ids.ext_to_row[f"v{i}"] for i in sel]] = True
    hits = port.search_ids(X[:16], 5, allow_rows=allow, mode="beam")
    ok_ext = {f"v{i}" for i in sel}
    assert all(h[0] in ok_ext for hl in hits for h in hl)
    o_allow = np.zeros(oracle._cap, bool)
    o_allow[sel] = True                     # oracle row i == v{i}
    _, gi = oracle.search(X[:16], 5, allow_rows=o_allow)
    hit = np.mean([
        len({h[0] for h in hits[b]}
            & {f"v{int(x)}" for x in np.asarray(gi)[b] if x >= 0}) / 5
        for b in range(16)])
    assert hit >= 0.8, hit


def test_sharded_beam_mode(pair):
    ref, port, oracle, X = pair
    Q = np.random.default_rng(7).normal(size=(32, 24)).astype(np.float32)
    _, gi = oracle.search(Q, 10)
    hits = port.search_ids(Q, 10, mode="beam")
    assert recall(hits, gi) >= 0.85
    assert overlap(hits, ref.search_ids(Q, 10, mode="beam")) >= 0.9


def test_sharded_projected_scan():
    """serve_proj_dim: per-shard projected scan under one shared basis,
    a local exact re-rank, exact distances at the merge."""
    rng = np.random.default_rng(11)
    d = 32
    X = (rng.normal(size=(4000, d)) * np.exp(-np.arange(d) / 5.0)
         ).astype(np.float32)
    cfg = HNSWConfig(m=8, serve_mode="scan", serve_proj_dim=8,
                     serve_proj_rerank=48)
    idx = ShardedHNSW(d, dist.L2, dist.F32, cfg, mesh=cpu(8))
    idx.add_batch([f"v{i}" for i in range(4000)], X)
    assert idx._get_proj() is not None
    basis = idx._proj_basis.numpy()
    for s in idx.shards:
        np.testing.assert_array_equal(s._proj_basis.numpy(), basis)
    hits = idx.search_ids(X[:64], 1)
    assert sum(hits[b][0][0] == f"v{b}" for b in range(64)) == 64
    q = X[:128] + 0.001
    _, sh_on, r_on = idx._search_raw(q, 10)
    idx.config.serve_proj_dim = 0
    _, sh_off, r_off = idx._search_raw(q, 10)
    idx.config.serve_proj_dim = 8
    agree = np.mean([
        len({(int(sh_on[b, j]), int(r_on[b, j])) for j in range(10)
             if r_on[b, j] >= 0}
            & {(int(sh_off[b, j]), int(r_off[b, j])) for j in range(10)})
        for b in range(128)]) / 10.0
    assert agree >= 0.95, agree
    gids = [idx.ids.ext_to_row[f"v{i}"] for i in range(0, 4000, 5)]
    hits = idx.search_ids(X[:16], 3, allow_rows=np.array(gids))
    assert all(int(ext[1:]) % 5 == 0 for hl in hits for ext, _ in hl)
    fresh = (X[0] * -5.0).astype(np.float32)
    idx.add("fresh", fresh)
    assert idx.search_ids(fresh, 1)[0][0][0] == "fresh"


# -- one state, both packages ---------------------------------------------

def from_reference(ref, cfg, metric, precision, n):
    """The port's ShardedHNSW over the reference's settled shard states
    (ShardedHNSW.from_reference_state)."""
    ref.settle_for_serving()
    shards = []
    for s in ref.shards:
        arrays = {f: np.asarray(v) for f, v in
                  jax.device_get(s.state)._asdict().items()}
        shards.append({
            "arrays": arrays,
            "ids": {"row_to_ext": list(s.ids.row_to_ext),
                    "free": list(s.ids.free)},
            "mirrors": {
                "deleted_rows": list(s._deleted_rows),
                "max_level": s._max_level, "up_free": list(s._up_free),
                "up_next": s._up_next, "unlinked": list(s._unlinked),
                "needs_refine": s.needs_refine,
                "serve_quantized": s._serve_quantized,
                "abs_max": float(s.quantizer.abs_max)
                if bool(s.quantizer.trained) else None,
                "rng_state": s.rng.bit_generator.state}})
    gids = {"row_to_ext": list(ref.ids.row_to_ext),
            "free": list(ref.ids.free),
            "loc_shard": ref._loc_shard.tolist(),
            "loc_row": ref._loc_row.tolist()}
    return ShardedHNSW.from_reference_state(
        shards, gids, HNSWConfig(**cfg), metric=metric, precision=precision,
        mesh=cpu(n))


@pytest.mark.parametrize("metric,precision", [
    ("euclidean", "float32"), ("cosine", "float32"),
    ("euclidean", "bfloat16"), ("cosine", "int8")])
def test_exact_scan_rows_equal_reference(metric, precision):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(1500, 16)).astype(np.float32)
    cfg = dict(m=8, ef_construction=32, chunk=128, serve_mode="scan",
               scan_exact=True)
    ref = JSharded(16, metric, precision, config=JConfig(**cfg),
                   mesh=jmake_mesh(4))
    ref.add_batch([f"v{i}" for i in range(1500)], X)
    ref.delete("v3")
    port = from_reference(ref, cfg, metric, precision, 4)
    Q = X[:40] + 0.01 * rng.normal(size=(40, 16)).astype(np.float32)
    same_raw(ref._search_raw(Q, 10), port._search_raw(Q, 10))
    dj, gj = ref.search(Q, 10)
    dt, gt = port.search(Q, 10)
    np.testing.assert_array_equal(gt, np.asarray(gj))
    d_dev, g_dev, _ = port.search_device(Q, 10)
    np.testing.assert_array_equal(g_dev.numpy(), gt)
    # a port built from the same write stream agrees too
    own = ShardedHNSW(16, metric, precision, config=HNSWConfig(**cfg),
                      mesh=cpu(4))
    own.add_batch([f"v{i}" for i in range(1500)], X)
    own.delete("v3")
    np.testing.assert_array_equal(own.search(Q, 10)[1], gt)


@pytest.mark.parametrize("k", [4, 10])
def test_merge_ties_follow_reference(k):
    """Every vector stored under 4 ids, which the hash sends to different
    shards: the tied copies meet at the merge, where the lower shard
    (then the lower local row) comes first, in both packages."""
    rng = np.random.default_rng(22)
    base = np.round(rng.normal(size=(150, 8)) * 4).astype(np.float32)
    X = np.repeat(base, 4, axis=0)
    ids = [f"c{i}_{j}" for i in range(150) for j in range(4)]
    cfg = dict(m=8, ef_construction=32, chunk=128, serve_mode="scan")
    ref = JSharded(8, "euclidean", config=JConfig(**cfg), mesh=jmake_mesh(4))
    ref.add_batch(ids, X)
    port = ShardedHNSW(8, dist.L2, config=HNSWConfig(**cfg), mesh=cpu(4))
    port.add_batch(ids, X)
    Q = base[:30]
    _, sj, rj = ref._search_raw(Q, k)
    dt, st, rt = port._search_raw(Q, k)
    assert (dt[:, 0] == dt[:, 1]).all()          # ties at the top
    np.testing.assert_array_equal(st, np.asarray(sj))
    np.testing.assert_array_equal(rt, np.asarray(rj))
    assert (np.diff(st[:, :4], axis=1) >= 0).all()   # lower shard first


def carry(ref):
    """The reference's sharded checkpoint, opened by the port."""
    arrays = {}
    st = jio.dump_index(ref, "x", arrays)
    enc = {k: np.array(a) for k, a in jckpt._encode_arrays(arrays).items()}
    return index_io.load_index(st, checkpoint.decode_arrays(enc), "x",
                               device="cpu")


def test_checkpoint_carries_sharded_state():
    rng = np.random.default_rng(23)
    X = rng.normal(size=(900, 16)).astype(np.float32)
    cfg = dict(m=8, ef_construction=32, chunk=128)
    ref = JSharded(16, "euclidean", config=JConfig(**cfg),
                   mesh=jmake_mesh(4))
    ref.add_batch([f"v{i}" for i in range(900)], X)
    ref.delete("v10")
    port = carry(ref)
    assert isinstance(port, ShardedHNSW) and port.n_shards == 4
    assert len(port) == len(ref) == 899
    Q = X[:32] + 0.01
    same_raw(ref._search_raw(Q, 5), port._search_raw(Q, 5))
    hits_j = ref.search_ids(Q, 5, mode="beam")
    assert overlap(port.search_ids(Q, 5, mode="beam"), hits_j) >= 0.9
    for e in ("v0", "v500", "v899"):
        np.testing.assert_array_equal(port.get_vector(e),
                                      np.asarray(ref.get_vector(e)))
    # and back: the port's checkpoint opens in the reference
    arrays = {}
    st = index_io.dump_index(port, "x", arrays)
    enc = checkpoint.encode_arrays(arrays)
    back = jio.load_index(st, jckpt._decode_arrays(enc), "x")
    assert isinstance(back, JSharded) and len(back) == 899
    same_raw(back._search_raw(Q, 5), port._search_raw(Q, 5))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sharded_data_dir_opens_in_either_package(tmp_path, writer):
    from kektordb_tpu.engine import Engine as JEngine
    from kektordb_tpu.engine import EngineConfig as JEngineConfig
    from kektordb_tpu_torch.engine import Engine, EngineConfig

    def port_engine():
        return Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                                   start_background=False)).open()

    def ref_engine():
        return JEngine(JEngineConfig(data_dir=str(tmp_path),
                                     start_background=False)).open()

    w, r = (ref_engine, port_engine) if writer == "reference" \
        else (port_engine, ref_engine)
    rng = np.random.default_rng(24)
    X = rng.normal(size=(400, 16)).astype(np.float32)
    e = w()
    e.create_index("sh", m=8, shards=4, serve_mode="scan")
    e.add_batch("sh", [f"v{i}" for i in range(400)], X,
                [{"grp": i % 3} for i in range(400)])
    e.delete("sh", "v9")
    want = e.search("sh", X[:12], k=6)
    wantf = e.search("sh", X[:4], k=5, filter="grp = 1")
    e.close()
    o = r()
    idx = o.indexes["sh"].index
    assert type(idx).__name__ == "ShardedHNSW" and idx.n_shards == 4
    for a, b in ((want, o.search("sh", X[:12], k=6)),
                 (wantf, o.search("sh", X[:4], k=5, filter="grp = 1"))):
        assert [[h["id"] for h in q] for q in a] == \
            [[h["id"] for h in q] for q in b]
        np.testing.assert_allclose(
            [[h["distance"] for h in q] for q in a],
            [[h["distance"] for h in q] for q in b], rtol=RTOL, atol=ATOL)
    o.close()


def test_make_mesh_counts_visible_devices(monkeypatch):
    assert make_mesh(8, "cpu") == cpu(8)
    with pytest.raises(ValueError, match="only 8 devices"):
        make_mesh(9, "cpu")
    monkeypatch.delenv(devlib.DEVICE_REPEAT_ENV)
    assert make_mesh(None, "cpu") == cpu(1)


def test_compress_serving_int8_shares_quantizer(pair):
    rng = np.random.default_rng(25)
    X = rng.normal(size=(800, 16)).astype(np.float32)
    ids = [f"v{i}" for i in range(800)]
    cfg = dict(m=8, ef_construction=32, chunk=128, serve_mode="scan")
    ref = JSharded(16, "euclidean", config=JConfig(**cfg), mesh=jmake_mesh(4))
    port = ShardedHNSW(16, dist.L2, config=HNSWConfig(**cfg), mesh=cpu(4))
    for idx in (ref, port):
        idx.add_batch(ids, X)
        idx.compress_serving("int8")
    assert {float(s.quantizer.abs_max) for s in port.shards} == \
        {float(ref.shards[0].quantizer.abs_max)}
    for s, r in zip(port.shards, ref.shards):
        n = s.ids.capacity_used
        np.testing.assert_array_equal(s.state.vectors[:n].numpy(),
                                      np.asarray(r.state.vectors)[:n])
    Q = X[:20] + 0.01
    same_raw(ref._search_raw(Q, 5), port._search_raw(Q, 5))


def test_state_fingerprint_tracks_writes(pair):
    _, port, _, X = pair
    a = port.state_fingerprint()
    assert a["shards"] == 8 and len(a["per_shard_crc32"]) == 8
    assert port.state_fingerprint(settle=False) == a
    port.add("fp-probe", X[1] + 7.0)
    assert port.state_fingerprint(settle=False) == {"stale": True}
    b = port.state_fingerprint()
    changed = [x != y for x, y in zip(a["per_shard_crc32"],
                                      b["per_shard_crc32"])]
    assert changed.count(True) == 1
