"""Data directories round-trip between the port's Engine and the JAX
package's, in both directions.

One package writes a data dir through the same sequence of engine calls
(clock of both fixed), then the other opens it:
* "ckpt": everything, then close() (a checkpoint, journal empty);
* "journal": everything, the journal flushed, the engine dropped without
  close() (replay only);
* "mixed": a checkpoint half-way, the rest only in the journal.
The opened engine must answer as the writer did before it stopped: the
same hit ids for plain, filtered and (memory index) text + decay
searches, distances within rtol 1e-5 (floor 1e-4), the same metadata,
edges, KV and config, deleted ids gone; a checkpointed hnsw index carries
its GraphState leaf for leaf (norms recomputed on load: rtol 1e-6).
Scenarios: a linked graph (serve_mode "auto", upper levels), bf16 and
int8 scan indexes, a memory-enabled index with text, kind "flat".

Also: an f32 index compressed to int8 serving survives a checkpoint both
ways (the reference's durability gate); a sharded checkpoint and a
sharded journal of the reference open in the port as one unsharded
index; a rejected op is not journaled; import_batch snapshots.
"""

import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index import HNSWIndex

RTOL, ATOL = 1e-5, 1e-4
T0 = 1.75e9
N, D = 600, 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def clock(monkeypatch):
    c = [T0]
    monkeypatch.setattr(time, "time", lambda: c[0])
    return c


def port(d):
    return Engine(EngineConfig(device="cpu", data_dir=str(d),
                               start_background=False)).open()


def ref(d):
    return JEngine(JEngineConfig(data_dir=str(d),
                                 start_background=False)).open()


OPEN = {"port": port, "ref": ref}
OTHER = {"port": "ref", "ref": "port"}

# name -> create_index kwargs
SCENARIOS = {
    "graph": dict(m=8, ef_construction=64),
    "bf16": dict(precision="bfloat16", serve_mode="scan"),
    "int8": dict(metric="cosine", precision="int8", serve_mode="scan"),
    "memory": dict(serve_mode="scan"),
    "flat": dict(kind="flat"),
}


def _data():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(N + 200, D)).astype(np.float32),
            rng.normal(size=(16, D)).astype(np.float32))


def _metas(lo, hi):
    words = ["apple", "river", "stone", "cloud", "ember", "frost"]
    return [{"grp": i % 4, "body": f"{words[i % 6]} {words[(i * 7) % 6]}",
             "_indexed_fields": ["body"]} for i in range(lo, hi)]


def first_half(eng, name, clock):
    X, _ = _data()
    eng.create_index(name, **SCENARIOS[name])
    eng.add_batch(name, [f"v{i}" for i in range(N)], X[:N], _metas(0, N))
    clock[0] += 60.0
    for i in range(N, N + 20):
        eng.add(name, f"v{i}", X[i], _metas(i, i + 1)[0])
    eng.link(name, "v1", "knows", "v2", weight=0.5, props={"p": 1},
             inverse="known_by")
    eng.link(name, "v3", "likes", "v4")
    eng.unlink(name, "v3", "likes", "v4")
    eng.kv_set("k1", b"\x00\x01")
    eng.kv_set("k2", "two")
    eng.kv_delete("k2")
    eng.update_metadata(name, "v5", {"grp": 9, "tag": "x"})
    for i in range(10, N, 37):
        eng.delete(name, f"v{i}")
    # one VCONFIG: the reference's replay keeps only an index's last one
    # (see test_replay_keeps_every_vconfig)
    eng.configure_index(name, {"ef_search": 48, "memory": {
        "enabled": name == "memory", "decay_half_life": 86400.0}})


def second_half(eng, name, clock):
    X, _ = _data()
    clock[0] += 60.0
    eng.add_batch(name, [f"w{i}" for i in range(100)],
                  X[N + 20:N + 120], _metas(N + 20, N + 120))
    for i in range(11, N, 41):
        eng.delete(name, f"v{i}")
    eng.delete(name, "w3")
    eng.update_metadata(name, "v6", {"grp": 7})       # a checkpointed row
    eng.update_metadata(name, "w5", {"grp": 8})       # a journaled row
    eng.reinforce(name, "v7")
    eng.link(name, "w1", "knows", "v1")
    eng.kv_set("k3", b"three")


def probe(eng, name):
    _, Q = _data()
    out = {"plain": eng.search(name, Q, k=10),
           "filtered": eng.search(name, Q[:4], k=8, filter="grp = 1")}
    if name == "memory":
        out["text"] = eng.search(name, Q[:4], k=8, text_query="apple ember",
                                 alpha=0.5)
    out["meta"] = {e: eng.get(name, e)["metadata"]
                   for e in ("v0", "v5", "v6", "v7", "w5", "w9")
                   if eng.indexes[name].index.ids.get(e) is not None}
    out["gone"] = sorted(e for e in ("v10", "v47", "v11", "w3")
                         if eng.indexes[name].index.ids.get(e) is not None)
    out["edges"] = {n: sorted((x["relation"], x["target"], x["weight"])
                              for x in eng.get_edges(name, n))
                    for n in ("v1", "v2", "v3", "w1")}
    out["kv"] = eng.kv_scan("")
    cfg = getattr(eng.indexes[name].index, "config", None)
    out["ef_search"] = cfg.ef_search if cfg is not None else None
    out["size"] = len(eng.indexes[name].index)
    return out


def assert_same_hits(a, b):
    for key in ("plain", "filtered", "text"):
        if key not in a:
            continue
        assert [[h["id"] for h in q] for q in a[key]] == \
            [[h["id"] for h in q] for q in b[key]], key
        for f in ("distance", "score"):
            np.testing.assert_allclose(
                [[h.get(f, 0.0) for h in q] for q in a[key]],
                [[h.get(f, 0.0) for h in q] for q in b[key]],
                rtol=RTOL, atol=ATOL, err_msg=f"{key} {f}")
    for key in ("meta", "gone", "edges", "kv", "ef_search", "size"):
        assert a[key] == b[key], key
    assert a["gone"] == []


def leaves(idx) -> dict:
    """An hnsw index's GraphState as numpy (bf16 as its bit pattern)."""
    if isinstance(idx, HNSWIndex):
        return {k: (t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t).numpy() for k, t in idx.state._asdict().items()}
    st = jax.device_get(idx.state)._asdict()
    return {k: (np.asarray(v).view(np.int16)
                if np.asarray(v).dtype == ml_dtypes.bfloat16
                else np.asarray(v)) for k, v in st.items()}


def crash(eng):
    """Drop an engine as a crash leaves it: the journal flushed, no
    checkpoint."""
    eng._aof.flush(fsync=True)
    eng._aof.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("mode", ["ckpt", "journal", "mixed"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_data_dir_opens_in_the_other_package(tmp_path, clock, name, mode,
                                             writer):
    w = OPEN[writer](tmp_path)
    first_half(w, name, clock)
    if mode == "mixed":
        clock[0] += 1.0
        w.save_snapshot()
    second_half(w, name, clock)
    want = probe(w, name)
    state = leaves(w.indexes[name].index) \
        if mode == "ckpt" and name != "flat" else None
    clock[0] += 1.0
    if mode == "ckpt":
        w.close()
    else:
        crash(w)
    r = OPEN[OTHER[writer]](tmp_path)
    got = probe(r, name)
    assert_same_hits(want, got)
    if state is not None:
        back = leaves(r.indexes[name].index)
        if name == "graph":
            assert int(state["max_level"]) > 0       # upper levels carried
        for k, v in state.items():
            # the reference's dtypes and shapes (0-d scalars included)
            assert (back[k].dtype, back[k].shape) == (v.dtype, v.shape), k
            if k == "norms":
                np.testing.assert_allclose(back[k], v, rtol=1e-6)
            else:
                np.testing.assert_array_equal(back[k], v, err_msg=k)
    clock[0] += 1.0
    r.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_int8_compressed_serving_survives_checkpoint(tmp_path, clock,
                                                     writer):
    """The reference's gate (tests/test_engine.py:359-380), across the
    packages: compress_serving('int8'), checkpoint, reload elsewhere."""
    X = np.random.default_rng(3).normal(size=(300, 16)).astype(np.float32)
    w = OPEN[writer](tmp_path)
    w.create_index("idx", m=8, ef_construction=64)
    w.add_batch("idx", [f"v{i}" for i in range(300)], X)
    w.indexes["idx"].index.compress_serving("int8")
    want = w.search("idx", X[:20], k=5)
    assert want[7][0]["id"] == "v7"
    clock[0] += 1.0
    w.close()
    r = OPEN[OTHER[writer]](tmp_path)
    assert r.indexes["idx"].index._serve_quantized
    got = r.search("idx", X[:20], k=5)
    assert [[h["id"] for h in q] for q in got] == \
        [[h["id"] for h in q] for q in want]
    np.testing.assert_allclose([[h["distance"] for h in q] for q in got],
                               [[h["distance"] for h in q] for q in want],
                               rtol=1e-3, atol=1e-3)
    clock[0] += 1.0
    r.close()


@pytest.mark.parametrize("mode", ["ckpt", "journal"])
def test_reference_sharded_data_dir_opens_unsharded(tmp_path, clock, mode):
    """Written by the reference on the 8-device CPU mesh with shards=4;
    the port (one card, no sharded index) opens it as one index, as the
    reference does on a host with fewer devices than shards."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(400, 16)).astype(np.float32)
    w = ref(tmp_path)
    w.create_index("sh", m=8, shards=4, serve_mode="scan")
    w.add_batch("sh", [f"v{i}" for i in range(400)], X,
                [{"grp": i % 3} for i in range(400)])
    w.delete("sh", "v9")
    want = w.search("sh", X[:12], k=6)
    wantf = w.search("sh", X[:4], k=5, filter="grp = 1")
    clock[0] += 1.0
    if mode == "ckpt":
        w.close()
    else:
        crash(w)
    r = port(tmp_path)
    idx = r.indexes["sh"].index
    assert isinstance(idx, HNSWIndex) and len(idx) == 399
    for a, b in ((want, r.search("sh", X[:12], k=6)),
                 (wantf, r.search("sh", X[:4], k=5, filter="grp = 1"))):
        assert [[h["id"] for h in q] for q in a] == \
            [[h["id"] for h in q] for q in b]
        np.testing.assert_allclose(
            [[h["distance"] for h in q] for q in a],
            [[h["distance"] for h in q] for q in b], rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="item 12"):
        r.create_index("again", shards=4)
    clock[0] += 1.0
    r.close()


def test_rejected_op_not_journaled(tmp_path, clock):
    e = port(tmp_path)
    e.create_index("idx", m=8)
    e.add("idx", "a", np.ones(8, np.float32))
    with pytest.raises(ValueError):
        e.add("idx", "bad", np.ones(3, np.float32))
    with pytest.raises(KeyError):
        e.add("idx", "a", np.ones(8, np.float32))
    with pytest.raises(KeyError):
        e.add_batch("idx", ["x", "x"], np.ones((2, 8), np.float32))
    with pytest.raises(ValueError):
        e.configure_index("idx", {"serve_mode": "warp", "ef_search": 3})
    assert e.indexes["idx"].index.config.ef_search == 100
    crash(e)
    for opener in (port, ref):
        e2 = opener(tmp_path)
        assert sorted(e2.indexes["idx"].index.ids.ext_to_row) == ["a"]
        assert e2.indexes["idx"].index.config.ef_search == 100
        crash(e2)


@pytest.mark.parametrize("mode", ["ckpt", "journal"])
def test_host_kind_data_dir_refused(tmp_path, clock, mode):
    """A data dir holding a `kind="host"` index (not ported) does not open:
    loud, naming its ROADMAP item; a failed open leaves no journal writer
    running."""
    w = ref(tmp_path)
    w.create_index("h", kind="host")
    w.add_batch("h", ["a", "b"], np.eye(2, 8, dtype=np.float32))
    clock[0] += 1.0
    if mode == "ckpt":
        w.close()
    else:
        crash(w)
    e = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                            start_background=False))
    with pytest.raises(NotImplementedError, match="item 10"):
        e.open()
    assert e._aof is None and not e._opened


def test_unopened_engine_writes_no_checkpoint(tmp_path, clock):
    e = port(tmp_path)
    e.create_index("keep", serve_mode="scan")
    e.add("keep", "a", np.ones(4, np.float32))
    clock[0] += 1.0
    e.close()
    clock[0] += 1.0
    Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                        start_background=False)).close()     # never opened
    r = port(tmp_path)
    assert r.search("keep", np.ones(4), k=1)[0][0]["id"] == "a"
    crash(r)


def test_import_batch_snapshots(tmp_path, clock):
    X = np.random.default_rng(5).normal(size=(200, 16)).astype(np.float32)
    e = port(tmp_path)
    e.create_index("imp", m=8, ef_construction=64)
    clock[0] += 1.0
    e.import_batch("imp", [f"v{i}" for i in range(200)], X)
    assert e._aof.size() == 0 and e._dirty == 0   # checkpointed, not journaled
    want = e.search("imp", X[:8], k=3)
    crash(e)
    r = ref(tmp_path)
    assert len(r.indexes["imp"].index) == 200
    assert [[h["id"] for h in q] for q in r.search("imp", X[:8], k=3)] == \
        [[h["id"] for h in q] for q in want]
    crash(r)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_replay_keeps_every_vconfig(tmp_path, clock, writer):
    """Two VCONFIGs of different keys in one journal: the port's replay
    applies both. (The reference's replay keeps only the last VCONFIG of
    an index, so its own reopen loses the memory setting here.)"""
    w = OPEN[writer](tmp_path)
    w.create_index("c", serve_mode="scan")
    w.add("c", "a", np.ones(4, np.float32))
    w.configure_index("c", {"memory": {"enabled": True}, "ef_search": 20})
    w.configure_index("c", {"ef_search": 48, "scan_exact": True})
    crash(w)
    r = port(tmp_path)
    h = r.indexes["c"]
    assert h.memory.enabled
    assert h.index.config.ef_search == 48 and h.index.config.scan_exact
    assert r.search("c", np.ones(4), k=1)[0][0]["id"] == "a"
    crash(r)


@pytest.mark.parametrize("knobs", [
    dict(snapshot_dirty_threshold=5),                    # dirty ops
    dict(snapshot_interval=0.0),                         # age
    dict(aof_rewrite_min_bytes=512, aof_rewrite_growth=1.0),  # AOF growth
], ids=["dirty", "interval", "aof_growth"])
def test_background_loop_snapshots(tmp_path, knobs):
    """The background loop's triggers (engine.go:277-320): a checkpoint is
    written and the journal emptied once enough ops are dirty, once the
    last snapshot is old enough, or once the journal has grown by
    aof_rewrite_growth past its size after the last snapshot."""
    cfg = dict(snapshot_dirty_threshold=10 ** 9, snapshot_interval=1e9)
    cfg.update(knobs)
    e = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                            **cfg)).open()
    e.create_index("b", serve_mode="scan")
    e.add_batch("b", [f"v{i}" for i in range(8)],
                np.eye(8, 16, dtype=np.float32))
    deadline = time.monotonic() + 10.0
    while e._dirty and time.monotonic() < deadline:
        time.sleep(0.1)
    assert e._dirty == 0 and e._aof.size() == 0
    e._stop.set()
    e._bg.join(timeout=5.0)
    assert not e._bg.is_alive()
    crash(e)
    r = port(tmp_path)
    assert len(r.indexes["b"].index) == 8
    crash(r)
