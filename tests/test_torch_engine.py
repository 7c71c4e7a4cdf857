"""Parity of the port's in-memory Engine with the JAX package's: the same
sequence of engine calls on the same seeded data gives the same hit ids,
with metadata filters, graph_root masks and deletes. Scores and distances
are held to rtol 1e-5 with an absolute floor of 1e-4 (float32 sums in
another order). The options the port defers raise NotImplementedError;
text and decay search are held to the reference in test_torch_fuse.py."""

import numpy as np
import pytest
import torch

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu_torch.engine import Engine, EngineConfig

RTOL, ATOL = 1e-5, 1e-4
N, D = 2000, 32


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def drive(eng, kind):
    """One engine sequence; returns every search's result."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N + 10, D)).astype(np.float32)
    Q = rng.normal(size=(12, D)).astype(np.float32)
    eng.create_index("e", metric="euclidean", kind=kind, serve_mode="scan")
    metas = [{"cat": ["a", "b", "c"][i % 3], "n": i} for i in range(N)]
    eng.add_batch("e", [f"v{i}" for i in range(N)], X[:N], metas)
    eng.add("e", "x0", X[N], {"cat": "a", "n": -1})
    for i in range(1, 6):
        eng.link("e", "v0", "knows", f"v{i * 37}")
    eng.link("e", "v37", "knows", "x0")
    out = [eng.search("e", Q, k=10),
           eng.search("e", Q[0], k=5, filter="cat = 'b' AND n > 1000"),
           eng.search("e", Q[:3], k=4, graph_root="v0", graph_depth=2),
           eng.search("e", Q[:4], k=10, columnar=True,
                      include_metadata=True)]
    for i in range(0, N, 9):
        eng.delete("e", f"v{i}")
    eng.update_metadata("e", "v1", {"cat": "z"})
    out += [eng.search("e", Q, k=10, filter="cat != 'a'"),
            eng.search("e", Q[:2], k=10, filter="cat = 'z'"),
            eng.search("e", X[1:3], k=3, columnar="np")]
    return out


def _ids(res):
    if isinstance(res, dict):
        return res["ids"]
    return [[h["id"] for h in hits] for hits in res]


def _vals(res, key):
    if isinstance(res, dict):
        return np.asarray(res[key + "s"], np.float64)
    return np.asarray([[h[key] for h in hits] for hits in res], np.float64)


def _user_meta(res):
    """Hit metadata without the insert timestamp each engine stamps."""
    return [[{k: v for k, v in m.items() if k != "_created_at"} for m in ms]
            for ms in res["metadata"]]


@pytest.mark.parametrize("kind", ["hnsw", "flat"])
def test_engine_sequence_same_hits(kind):
    ref = JEngine(JEngineConfig(start_background=False)).open()
    port = Engine(EngineConfig(device="cpu", start_background=False)).open()
    try:
        ref_out, port_out = drive(ref, kind), drive(port, kind)
        for r, p in zip(ref_out, port_out):
            assert _ids(r) == _ids(p)
            for key in ("score", "distance"):
                np.testing.assert_allclose(_vals(r, key), _vals(p, key),
                                           rtol=RTOL, atol=ATOL)
        assert _user_meta(ref_out[3]) == _user_meta(port_out[3])
        assert ref.get("e", "v1")["metadata"]["cat"] \
            == port.get("e", "v1")["metadata"]["cat"] == "z"
        ri, pi = ref.index_info("e"), port.index_info("e")
        for key in ("size", "metric", "precision", "dimensions", "deleted",
                    "mask_cache"):
            assert ri[key] == pi[key], key
        assert ref.get_edges("e", "v0") == port.get_edges("e", "v0")
        assert ref.find_path("e", "v0", "x0") == port.find_path(
            "e", "v0", "x0")
        assert ref.traverse("e", "v0", "knows.knows") == port.traverse(
            "e", "v0", "knows.knows")
        rs, ps = (eng.extract_subgraph("e", "v0", 2, guide_vector=np.ones(D))
                  for eng in (ref, port))
        assert rs["nodes"] == ps["nodes"]
        assert sorted(map(str, rs["edges"])) == sorted(map(str, ps["edges"]))
        rg, pg = (eng.search_graph("e", np.ones(D), k=3)
                  for eng in (ref, port))
        assert [[(h["id"], h["edges"]) for h in hs] for hs in rg] == \
            [[(h["id"], h["edges"]) for h in hs] for hs in pg]
        assert ref.unlink("e", "v37", "knows", "x0") is True
        assert port.unlink("e", "v37", "knows", "x0") is True
        assert ref.run_maintenance() == port.run_maintenance()
        assert _ids(ref.search("e", np.ones(D), k=5)) == _ids(
            port.search("e", np.ones(D), k=5))
    finally:
        ref.close()
        port.close()


def test_engine_host_surface():
    eng = Engine(EngineConfig(device="cpu", start_background=False)).open()
    eng.create_index("e", serve_mode="scan")
    assert eng.search("e", np.zeros(4), k=3) == [[]]       # empty: lazy
    eng.add_batch("e", ["a", "b"], np.eye(2, 4, dtype=np.float32))
    with pytest.raises(KeyError):
        eng.add("e", "a", np.ones(4))
    with pytest.raises(ValueError):
        eng.add("e", "c", np.ones(3))
    with pytest.raises(KeyError):
        eng.create_index("e", serve_mode="scan")
    eng.kv_set("k", b"v")
    assert eng.kv_get("k") == b"v" and eng.kv_scan("k") == [("k", b"v")]
    eng.evolve("e", "a", "a2", np.ones(4))
    assert eng.evolution_chain("e", "a2") == ["a2", "a"]
    assert eng.get("e", "a")["metadata"]["_is_historical"] is True
    assert eng.stats()["indexes"]["e"]["size"] == 3
    assert eng.list_indexes() == ["e"]
    eng.drop_index("e")
    assert eng.list_indexes() == []
    eng.close()


# (call, ported): serve_mode "auto" and "beam" came with the graph slice,
# text_query with the fusion slice, data_dir and serve_proj_dim with the
# persistence slice, and now run; the rest still raise, naming their
# ROADMAP item
@pytest.mark.parametrize("call,ported", [
    (lambda e: Engine(EngineConfig(device="cpu", data_dir="/nonexistent")),
     True),
    (lambda e: e.create_index("s", shards=2, serve_mode="scan"), False),
    (lambda e: e.create_index("h", kind="host"), False),
    (lambda e: e.create_index("a"), True),               # serve_mode="auto"
    (lambda e: e.create_index("b", serve_mode="beam"), True),
    (lambda e: e.create_index("p", serve_mode="scan", serve_proj_dim=8),
     True),
    (lambda e: e.search("t", np.ones(4), text_query="hello"), True),
], ids=[f"call{i}" for i in range(7)])
def test_deferred_options_raise(call, ported):
    eng = Engine(EngineConfig(device="cpu", start_background=False)).open()
    eng.create_index("t", serve_mode="scan")
    eng.add("t", "a", np.ones(4))
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call(eng)
        eng.close()
        return
    call(eng)
    name = eng.list_indexes()[0]       # "a", "b" or "p" (before "t"), or "t"
    eng.add(name, "x", np.full(4, 3.0))
    assert eng.search(name, np.full(4, 3.0), k=1)[0][0]["id"] == "x"
    eng.close()


def test_decay_enabled_raises():
    """Named when a decay-enabled search was refused: since the fusion
    slice it runs, through the device epilogue, and decay=False skips the
    decay."""
    from kektordb_tpu_torch.engine import fusion
    eng = Engine(EngineConfig(device="cpu", start_background=False)).open()
    eng.create_index("t", serve_mode="scan")
    eng.add("t", "a", np.ones(4))
    eng.indexes["t"].memory = fusion.MemoryConfig(enabled=True)
    assert eng.search("t", np.ones(4))[0][0]["id"] == "a"
    assert eng.indexes["t"].decay_dev is not None
    assert eng.search("t", np.ones(4), decay=False)[0][0]["id"] == "a"
