"""A crash and a reopen give back the writer's live state: journal replay
in order.

A writer (the port's Engine or the JAX package's) runs a sequence of
engine calls with the clock of both fixed and advanced per call; its
journal is flushed and the engine dropped without close() (a crash). The
port reopens the data dir (checkpoint + replay), and must answer as the
writer did: index names, ids, stored vectors bit for bit, metadata, every
edge with its created_at, ef_search, KV, and a search by each live
vector (ids and distances within 1e-5). Then it closes (a checkpoint) and
reopens, and must answer so again.

The scenarios are the replay's order faults, each with and without a
checkpoint between the writes: an index dropped and created again under
its name; a row deleted and added again with another vector; a link to a
row deleted later in the journal (and a link made after its re-add); a
delete of an id with no row but with edges; flat and hnsw indexes, and
a port index of 2 shards. A seeded random sequence of every journaled
call adds the cases the scenarios miss.

The JAX package's replay keeps these faults (it is not edited); the
`test_reference_*` cases pin what it gives back instead. Also: a lazy
`kind="host"` index checkpointed before its first add keeps its
projection request.
"""

import time

import numpy as np
import pytest
import torch
from test_torch_native import private_reference_native

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.engine.engine import _graph_to_state

RTOL, ATOL = 1e-5, 1e-5
T0 = 1.75e9
D = 8
KINDS = {"flat": dict(kind="flat"),
         "hnsw": dict(m=8, ef_construction=32)}
# the scenarios' kinds: a port index of 2 shards besides
KIND_ARGS = {**KINDS, "sharded": dict(m=8, ef_construction=32, shards=2)}


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's replay scans on its C++ library, built for this
    module alone."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


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


def crash(eng):
    """Drop an engine as a crash leaves it: the journal flushed, no
    checkpoint."""
    eng._aof.flush(fsync=True)
    eng._aof.close()


def vec(i: int) -> np.ndarray:
    return np.random.default_rng(100 + i).normal(size=D).astype(np.float32)


def snapshot(eng, nodes) -> dict:
    """What a user reads back: per index its ids, vectors, metadata and
    ef_search, and a k=3 search by each live vector; KV; the live edges of
    every node in `nodes` (both directions, created_at included)."""
    out = {"names": sorted(eng.indexes), "kv": eng.kv_scan("")}
    for name in sorted(eng.indexes):
        h = eng.indexes[name]
        idx = h.index
        ids = sorted(idx.ids.ext_to_row)
        cfg = getattr(idx, "config", None)
        got = {"ids": ids,
               "meta": {e: h.meta.get(idx.ids.get(e)) for e in ids},
               "ef_search": cfg.ef_search if cfg is not None else None}
        if ids:
            X = np.stack([np.asarray(idx.get_vector(e), np.float32)
                          for e in ids])
            got["vectors"] = X.tobytes()
            hits = eng.search(name, X, k=3)
            got["hits"] = [[x["id"] for x in q] for q in hits]
            got["dist"] = [[x["distance"] for x in q] for q in hits]
        out[name] = got
    out["edges"] = {f"{i}/{n}": (sorted((x["relation"], x["target"], x["weight"],
                                x["created_at"])
                               for x in eng.get_edges(i, n)),
                        sorted((x["relation"], x["source"], x["created_at"])
                               for x in eng.get_incoming_edges(i, n)))
                    for i, n in nodes}
    return out


def assert_same(want: dict, got: dict, label: str) -> None:
    for key in want:
        if key in ("kv", "names", "edges"):
            assert got[key] == want[key], f"{label}: {key}"
            continue
        w, g = want[key], got[key]
        for k in w:
            if k == "dist":
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{label}: {key} {k}")
            else:
                assert g[k] == w[k], f"{label}: {key} {k}"


def reopen_twice(tmp_path, clock, want, nodes, graph_state=None):
    """The port's crash reopen, then its close-and-reopen, each against
    the writer's live state (and, for a port writer, its whole graph with
    the dead edges' deleted_at)."""
    for label in ("crash reopen", "close-and-reopen"):
        clock[0] += 1.0
        r = port(tmp_path)
        assert_same(want, snapshot(r, nodes), label)
        if graph_state is not None:
            assert _graph_to_state(r.graph) == graph_state, label
        clock[0] += 1.0
        if label == "crash reopen":
            r.close()
        else:
            crash(r)


# ---------------------------------------------------------------- scenarios

def drop_recreate(e, kind, clock, ckpt):
    """Fault 1: an index dropped and created again under its name."""
    e.create_index("i", **KIND_ARGS[kind])
    e.add_batch("i", ["a", "b"], np.stack([vec(0), vec(1)]))
    e.link("i", "a", "r", "b")
    if ckpt:
        clock[0] += 1.0
        e.save_snapshot()
    clock[0] += 1.0
    e.drop_index("i")
    e.create_index("i", **KIND_ARGS[kind])
    e.add("i", "c", vec(2), {"gen": 2})
    e.link("i", "c", "r", "a")


def readd(e, kind, clock, ckpt):
    """Fault 2: a row deleted and added again with another vector."""
    e.create_index("i", **KIND_ARGS[kind])
    e.add("i", "a", vec(0), {"v": 0})
    e.add("i", "b", np.zeros(D, np.float32), {"v": 1, "old": True})
    e.update_metadata("i", "b", {"patched": 1})
    if ckpt:
        clock[0] += 1.0
        e.save_snapshot()
    clock[0] += 1.0
    e.update_metadata("i", "b", {"patched": 2})
    e.delete("i", "b")
    e.add("i", "b", np.full(D, 5.0, np.float32), {"v": 2})


def link_delete(e, kind, clock, ckpt):
    """Fault 3: links to and from a row deleted later in the journal."""
    e.create_index("i", **KIND_ARGS[kind])
    e.add_batch("i", list("abcd"), np.stack([vec(i) for i in range(4)]))
    e.link("i", "a", "r", "b")
    e.link("i", "b", "s", "c", weight=0.5)
    if ckpt:
        clock[0] += 1.0
        e.save_snapshot()
    clock[0] += 1.0
    e.link("i", "d", "r", "b")
    e.delete("i", "b")


def link_readd(e, kind, clock, ckpt):
    """Fault 3 with a re-add: the link before the delete is gone, the one
    after the re-add stays."""
    link_delete(e, kind, clock, ckpt)
    clock[0] += 1.0
    e.add("i", "b", vec(9))
    e.link("i", "c", "r", "b")
    e.link("i", "b", "s", "d")


def delete_no_row(e, kind, clock, ckpt):
    """A delete of an id that has no row but has edges drops nothing, as
    the live delete does."""
    e.create_index("i", **KIND_ARGS[kind])
    e.add("i", "a", vec(0))
    e.link("i", "a", "r", "ghost")
    e.link("i", "ghost", "s", "a")
    if ckpt:
        clock[0] += 1.0
        e.save_snapshot()
    clock[0] += 1.0
    e.delete("i", "ghost")
    e.add("i", "ghost", vec(1))
    e.delete("i", "ghost")
    e.link("i", "a", "t", "ghost")


SCENARIOS = {f.__name__: f for f in (drop_recreate, readd, link_delete,
                                     link_readd, delete_no_row)}
NODES = [("i", n) for n in ("a", "b", "c", "d", "ghost")]


@pytest.mark.parametrize("ckpt", [False, True], ids=["journal", "mixed"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_reopen_gives_back_live_state(tmp_path, clock, scenario, writer,
                                      kind, ckpt):
    w = OPEN[writer](tmp_path)
    SCENARIOS[scenario](w, kind, clock, ckpt)
    want = snapshot(w, NODES)
    graph = _graph_to_state(w.graph) if writer == "port" else None
    crash(w)
    reopen_twice(tmp_path, clock, want, NODES, graph)
    if scenario == "drop_recreate":
        assert want["i"]["ids"] == ["c"]
    if scenario == "readd":
        assert want["i"]["hits"][1][0] == "b" and want["i"]["dist"][1][0] == 0
    if scenario in ("link_delete", "link_readd"):
        assert ("r", "b") not in {x[:2] for x in want["edges"]["i/a"][0]}


@pytest.mark.parametrize("ckpt", [False, True], ids=["journal", "mixed"])
@pytest.mark.parametrize("scenario", ["drop_recreate", "readd",
                                      "link_readd"])
def test_sharded_index_reopens_as_written(tmp_path, clock, monkeypatch,
                                          scenario, ckpt):
    """A port index of 2 shards (one device repeated): its own delete and
    id map go through the same replay."""
    monkeypatch.setenv("KEKTOR_TORCH_DEVICE_REPEAT", "2")
    w = port(tmp_path)
    SCENARIOS[scenario](w, "sharded", clock, ckpt)
    assert w.indexes["i"].index.n_shards == 2
    want = snapshot(w, NODES)
    graph = _graph_to_state(w.graph)
    crash(w)
    reopen_twice(tmp_path, clock, want, NODES, graph)


def test_reference_drops_a_recreated_index(tmp_path, clock):
    """Fault 1 in the JAX package: its replay reads the VDROP as the end
    of the name and skips the later VCREATE and adds, so its reopen has
    no index "i" (the port's has "i" with "c")."""
    w = port(tmp_path)
    drop_recreate(w, "flat", clock, False)
    crash(w)
    r = ref(tmp_path)
    assert "i" not in r.indexes
    crash(r)
    p = port(tmp_path)
    assert sorted(p.indexes["i"].index.ids.ext_to_row) == ["c"]
    crash(p)


def test_reference_keeps_a_readded_rows_old_vector(tmp_path, clock):
    """Fault 2 in the JAX package: after a checkpoint, a delete and a
    re-add compact to the re-add; its replay re-adds only ids without a
    row, so the checkpoint's vector stays and the new metadata merges into
    the old row's (the port's reopen has the new vector and metadata)."""
    w = port(tmp_path)
    readd(w, "flat", clock, True)
    crash(w)
    five = np.full(D, 5.0, np.float32)
    r = ref(tmp_path)
    np.testing.assert_array_equal(r.indexes["i"].index.get_vector("b"),
                                  np.zeros(D, np.float32))
    assert r.get("i", "b")["metadata"]["old"] is True
    assert r.search("i", five, k=1)[0][0]["id"] == "a"
    crash(r)
    p = port(tmp_path)
    np.testing.assert_array_equal(p.indexes["i"].index.get_vector("b"), five)
    assert "old" not in p.get("i", "b")["metadata"]
    hit = p.search("i", five, k=1)[0][0]
    assert (hit["id"], hit["distance"]) == ("b", 0.0)
    crash(p)


def test_reference_brings_back_a_deleted_rows_link(tmp_path, clock):
    """Fault 3 in the JAX package: its replay deletes (and drops the
    graph node) inside the bulk apply, before the links of the journal,
    so a -> b comes back after b's delete (the port's does not)."""
    w = port(tmp_path)
    link_delete(w, "flat", clock, False)
    assert w.get_edges("i", "a") == []
    crash(w)
    r = ref(tmp_path)
    assert [x["target"] for x in r.get_edges("i", "a")] == ["b"]
    crash(r)
    p = port(tmp_path)
    assert p.get_edges("i", "a") == []
    crash(p)


def test_vdel_frame_carries_its_time(tmp_path, clock):
    """The port's VDEL frame carries the delete's time, so the replayed
    node drop ends the edges when the live one did (at_time reads agree);
    the JAX package reads the same journal."""
    w = port(tmp_path)
    link_delete(w, "flat", clock, False)
    t_del = clock[0]
    clock[0] += 100.0
    crash(w)
    r = port(tmp_path)
    assert [x["target"] for x in r.get_edges("i", "a", at_time=t_del - 0.5)
            ] == ["b"]
    assert r.get_edges("i", "a", at_time=t_del) == []
    crash(r)
    j = ref(tmp_path)
    assert sorted(j.indexes["i"].index.ids.ext_to_row) == ["a", "c", "d"]
    crash(j)


# ------------------------------------------------------- random sequences

POOL = [f"x{i}" for i in range(10)]
OPS = ["create", "add", "add_batch", "delete", "readd", "meta", "link",
       "unlink", "drop", "configure", "kv_set", "kv_del", "checkpoint"]
WEIGHTS = np.array([2, 10, 3, 5, 4, 4, 6, 2, 1.5, 1.5, 2, 1, 1.5])


def random_ops(e, rng, clock, n_ops: int = 40) -> None:
    """n_ops engine calls drawn from OPS over two index names; ids from
    POOL, vectors from the generator. Calls the engine would refuse are
    not made."""
    kinds: dict[str, str] = {}
    live: dict[str, set] = {}
    edges: list[tuple] = []
    vid = [1000]

    def new_vec():
        vid[0] += 1
        return vec(vid[0])

    for _ in range(n_ops):
        clock[0] += 1.0
        op = OPS[rng.choice(len(OPS), p=WEIGHTS / WEIGHTS.sum())]
        names = sorted(kinds)
        if op == "create" or not names:
            free = [n for n in ("p", "q") if n not in kinds]
            if free:
                n = free[int(rng.integers(len(free)))]
                kinds[n] = str(rng.choice(list(KINDS)))
                live[n] = set()
                e.create_index(n, **KINDS[kinds[n]])
            continue
        n = names[int(rng.integers(len(names)))]
        absent = [x for x in POOL if x not in live[n]]
        present = sorted(live[n])
        if op == "add" and absent:
            x = absent[int(rng.integers(len(absent)))]
            meta = {"g": int(rng.integers(3))} if rng.random() < 0.7 else None
            e.add(n, x, new_vec(), meta)
            live[n].add(x)
        elif op == "add_batch" and len(absent) >= 2:
            xs = list(rng.choice(absent, size=2, replace=False))
            e.add_batch(n, xs, np.stack([new_vec(), new_vec()]),
                        [{"g": 9}, None])
            live[n].update(xs)
        elif op == "delete":
            x = POOL[int(rng.integers(len(POOL)))]
            e.delete(n, x)
            live[n].discard(x)
        elif op == "readd" and present:
            x = present[int(rng.integers(len(present)))]
            e.delete(n, x)
            e.add(n, x, new_vec(), {"re": 1})
        elif op == "meta" and present:
            x = present[int(rng.integers(len(present)))]
            e.update_metadata(n, x, {"g": int(rng.integers(3)), "m": 1})
        elif op == "link":
            a, b = rng.choice(POOL, size=2, replace=False)
            rel = str(rng.choice(["r", "s"]))
            e.link(n, str(a), rel, str(b), weight=float(rng.integers(1, 4)))
            edges.append((n, str(a), rel, str(b)))
        elif op == "unlink" and edges:
            e.unlink(*edges.pop(int(rng.integers(len(edges)))))
        elif op == "drop":
            e.drop_index(n)
            del kinds[n], live[n]
        elif op == "configure":
            e.configure_index(n, {"ef_search": int(rng.choice([16, 24, 48]))})
        elif op == "kv_set":
            e.kv_set(f"k{int(rng.integers(4))}", f"v{int(rng.integers(99))}")
        elif op == "kv_del":
            e.kv_delete(f"k{int(rng.integers(4))}")
        elif op == "checkpoint":
            e.save_snapshot()


RANDOM_NODES = [(n, x) for n in ("p", "q") for x in POOL]


@pytest.mark.parametrize("seed", range(24))
def test_random_ops_reopen_as_written(tmp_path, clock, seed):
    """Seeded sequences (numpy generators: every run tries the same ones);
    the JAX package writes the odd seeds."""
    writer = "port" if seed % 2 == 0 else "ref"
    w = OPEN[writer](tmp_path)
    random_ops(w, np.random.default_rng(7000 + seed), clock)
    want = snapshot(w, RANDOM_NODES)
    graph = _graph_to_state(w.graph) if writer == "port" else None
    crash(w)
    reopen_twice(tmp_path, clock, want, RANDOM_NODES, graph)


# ------------------------------------------- the host index's projection

@pytest.mark.parametrize("request_", [None, 0], ids=["auto", "off"])
def test_lazy_host_checkpoint_keeps_projection_request(tmp_path, clock,
                                                       request_):
    """A kind="host" index checkpointed before its first add reopens with
    the request create_index took: the default ("auto") resolves as a
    fresh index's does, an explicit 0 stays 0."""
    kw = {} if request_ is None else {"serve_proj_dim": request_}
    e = port(tmp_path / "dir")
    e.create_index("h", kind="host", **kw)
    clock[0] += 1.0
    e.close()
    r = port(tmp_path / "dir")
    r.add("h", "a", vec(0))
    fresh = Engine(EngineConfig(device="cpu", start_background=False))
    fresh.create_index("h", kind="host", **kw)
    fresh.add("h", "a", vec(0))
    got, want = r.indexes["h"].index, fresh.indexes["h"].index
    assert got._proj_auto == want._proj_auto == (request_ is None)
    assert got.proj_dim == want.proj_dim == 0
    crash(r)


def test_reference_lazy_host_checkpoint_forces_full_sweep(tmp_path, clock):
    """The JAX package's lazy state drops the request, so its reopen of
    the same dir turns "auto" off; a lazy state it wrote (no request key)
    opens in the port as before, also off."""
    e = port(tmp_path / "a")
    e.create_index("h", kind="host")
    clock[0] += 1.0
    e.close()
    r = ref(tmp_path / "a")
    r.add("h", "a", vec(0))
    assert r.indexes["h"].index._proj_auto is False
    crash(r)
    j = ref(tmp_path / "b")
    j.create_index("h", kind="host")
    clock[0] += 1.0
    j.close()
    p = port(tmp_path / "b")
    p.add("h", "a", vec(0))
    assert p.indexes["h"].index._proj_auto is False
    crash(p)


def test_configure_reaches_a_lazy_host_index(tmp_path, clock):
    """serve_proj_dim set by configure_index before the first add is the
    request the arena is built with, live and after a replay."""
    e = port(tmp_path)
    e.create_index("h", kind="host")
    e.configure_index("h", {"serve_proj_dim": 0})
    e.add("h", "a", vec(0))
    assert e.indexes["h"].index._proj_auto is False
    crash(e)
    r = port(tmp_path)
    assert r.indexes["h"].index._proj_auto is False
    crash(r)
