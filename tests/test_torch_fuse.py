"""Hybrid text + decay search: the port (kektordb_tpu_torch/ops/fuse.py and
the Engine paths that use it) against the JAX package on the same seeded
inputs.

* `_fuse_topk` against the reference's XLA function: pads, text rows that
  are also vector candidates, a query with no valid candidate, decay off
  and each of the four decay models. Both compute in float32: scores
  within 1e-6 absolute (exp / exp2 may differ in the last ulp), equal rows
  and distances.
* `prepare_text`, `build_decay_device` and `update_decay_device`: equal
  arrays at one epoch.
* One engine sequence on the JAX Engine and on the port's
  Engine(device="cpu") with the clock of both fixed: hybrid at alpha 0,
  0.5 and 1, text-only, filtered hybrid, decay, reinforce, decay again,
  auto-links, configure_index knobs and belief_state. Equal ids; scores
  and distances within rtol 1e-5 and 1e-4 absolute, as in
  test_torch_engine.py (float32 sums in another order). "hnsw" serves
  from the scan through the device epilogue, "flat" through the host path
  (`_assemble_fused`, float64).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu.engine import fusion as jfusion
from kektordb_tpu.engine.metadata import DecayColumns as JDecayColumns
from kektordb_tpu.ops import fuse as jfuse
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.engine import fusion
from kektordb_tpu_torch.engine.metadata import DecayColumns
from kektordb_tpu_torch.ops import fuse

T0 = 1.7e9
DAY = 86400.0


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _epilogue_inputs(seed, B=6, F=16, T=64, cap=200):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cap, size=(B, F)).astype(np.int32)
    rows[rng.random((B, F)) < 0.2] = -1             # pads
    rows[-1] = -1                                    # no valid candidate
    d = np.where(rows >= 0, rng.random((B, F)) * 10, np.inf).astype(
        np.float32)
    n_text = 40
    # half of the text rows are also vector candidates of some query
    text = np.unique(np.concatenate([rows[rows >= 0][:n_text // 2],
                                     rng.integers(0, cap, n_text)]))
    tr, tsn = fuse.prepare_text(text.astype(np.int64), rng.random(text.size),
                                cap_t=T)
    return d, rows, tr, tsn


def _packed(seed, model, cap=200):
    rng = np.random.default_rng(seed)
    p = np.zeros((cap, 4), np.float32)
    p[:, 0] = -rng.random(cap) * 5 * DAY
    p[:, 1] = np.where(rng.random(cap) < 0.8, 1.0 / DAY, 0.0)  # 20% inactive
    p[:, 2] = model
    return p


@pytest.mark.parametrize("model", [None, 0, 1, 2, 3],
                         ids=["off", "exponential", "linear", "step",
                              "ebbinghaus"])
@pytest.mark.parametrize("alpha", [0.0, 0.6, 1.0])
def test_fuse_topk_matches_reference(model, alpha):
    d, rows, tr, tsn = _epilogue_inputs(seed=5)
    k, scale, now_rel = 12, 1.5, 3600.0
    jdec = tdec = None
    if model is not None:
        p = _packed(6, model)
        jdec, tdec = jnp.asarray(p), torch.from_numpy(p)
    want = jfuse._fuse_topk(jnp.asarray(d), jnp.asarray(rows),
                            jnp.asarray(tr), jnp.asarray(tsn),
                            jnp.float32(alpha), jnp.float32(scale), k,
                            decay=jdec, now_rel=None if jdec is None
                            else jnp.float32(now_rel))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    got = fuse._fuse_topk(torch.from_numpy(d), torch.from_numpy(rows),
                          torch.from_numpy(tr), torch.from_numpy(tsn),
                          f32(alpha), f32(scale), k, decay=tdec,
                          now_rel=None if tdec is None else f32(now_rel))
    ws, wr, wd = (np.asarray(x) for x in want)
    gs, gr, gd = (x.numpy() for x in got)
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gr[fin], wr[fin])
    np.testing.assert_array_equal(gd[fin], wd[fin])
    # the query with no valid vector candidate answers from the text
    assert set(gr[-1][fin[-1]].tolist()) <= set(tr.tolist())


@pytest.mark.parametrize("n,cap_t", [(0, 512), (30, 512), (900, 512)])
def test_prepare_text_matches_reference(n, cap_t):
    rng = np.random.default_rng(n)
    rows = rng.choice(5000, n, replace=False).astype(np.int64)
    vals = rng.random(n)
    for a, b in zip(fuse.prepare_text(rows, vals, cap_t),
                    jfuse.prepare_text(rows, vals, cap_t)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _fill_decay(cols, fus, n=300, seed=9):
    rng = np.random.default_rng(seed)
    for i in range(n):
        m = {fus.CREATED_KEY: T0 - rng.random() * 30 * DAY,
             fus.ACCESS_COUNT_KEY: int(rng.integers(0, 6))}
        if i % 11 == 0:
            m[fus.PINNED_KEY] = True
        if i % 7 == 0:
            m[fus.ACCESSED_KEY] = T0 - rng.random() * DAY
        if i % 3 == 0:
            m[fus.LAYER_KEY] = "episodic" if i % 2 else "semantic"
        if i % 13 != 5:                        # some rows never stamped
            cols.set_row(i, m)


def test_decay_mirror_matches_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    jc, tc = JDecayColumns(), DecayColumns()
    _fill_decay(jc, jfusion)
    _fill_decay(tc, fusion)
    layers = {"episodic": dict(decay_half_life=3600.0, decay_model="linear"),
              "semantic": dict(decay_half_life=0.0,
                               decay_model="ebbinghaus")}
    jcfg = jfusion.MemoryConfig(
        enabled=True, decay_half_life=DAY, decay_model="step",
        layers={k: jfusion.LayerConfig(**v) for k, v in layers.items()})
    tcfg = fusion.MemoryConfig(
        enabled=True, decay_half_life=DAY, decay_model="step",
        layers={k: fusion.LayerConfig(**v) for k, v in layers.items()})
    cap = 512
    jd = jfuse.build_decay_device(jc, jcfg, cap)
    td = fuse.build_decay_device(tc, tcfg, cap, "cpu")
    assert td.epoch == jd.epoch == T0
    np.testing.assert_array_equal(td.packed.numpy(), np.asarray(jd.packed))
    # reinforce-like writes on a few rows, then the incremental refresh
    monkeypatch.setattr(time, "time", lambda: T0 + 600.0)
    for cols, fus in ((jc, jfusion), (tc, fusion)):
        for r in (3, 44, 299, 17):
            cols.set_row(r, {fus.CREATED_KEY: T0 - DAY,
                             fus.ACCESSED_KEY: T0 + 600.0,
                             fus.ACCESS_COUNT_KEY: 9})
    before = td.packed
    jd2 = jfuse.update_decay_device(jd, jc, jcfg, [3, 44, 299, 17, 9999])
    td2 = fuse.update_decay_device(td, tc, tcfg, [3, 44, 299, 17, 9999])
    assert td2.packed is before                   # in place
    np.testing.assert_array_equal(td2.packed.numpy(), np.asarray(jd2.packed))
    np.testing.assert_array_equal(
        td2.packed.numpy(),
        fuse._pack_rows(tc, tcfg, np.arange(cap), td2.epoch))


VOCAB = [f"w{i}" for i in range(60)]


def _texts(n, rng):
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(VOCAB, size=rng.integers(4, 10), p=p))
            for _ in range(n)]


def drive(eng, kind, clock):
    """One engine sequence; returns every search's result and the other
    calls' outputs."""
    N, D = 600, 16
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N + 4, D)).astype(np.float32)
    Q = rng.normal(size=(8, D)).astype(np.float32)
    eng.create_index("m", kind=kind, serve_mode="scan")
    metas = [{"body": t, "_indexed_fields": ["body"], "grp": i % 4,
              "_created_at": T0 - float(rng.random()) * 30 * DAY}
             for i, t in enumerate(_texts(N, rng))]
    for i in range(0, N, 9):
        metas[i]["_memory_layer"] = "episodic"
    for i in range(0, N, 17):
        metas[i]["_pinned"] = True
    eng.add_batch("m", [f"v{i}" for i in range(N)], X[:N], metas)
    out = []
    for alpha in (0.0, 0.5, 1.0):
        out.append(eng.search("m", Q, k=10, text_query="w3 w7 w12",
                              alpha=alpha))
    out += [eng.search("m", np.zeros(D), k=10, text_query="w5 w1"),
            eng.search("m", Q[:3], k=8, text_query="w2 w9", alpha=0.4,
                       filter="grp = 2"),
            eng.search("m", Q[:3], k=6, text_query="w4", alpha=0.5,
                       columnar=True, include_metadata=True)]
    eng.configure_index("m", {"memory": {
        "enabled": True, "decay_half_life": DAY,
        "layers": {"episodic": {"decay_half_life": 3600.0,
                                "decay_model": "linear"}}}})
    clock[0] = T0 + 3600.0
    out += [eng.search("m", Q, k=10),
            eng.search("m", Q, k=10, text_query="w3 w7", alpha=0.6),
            eng.search("m", Q[:2], k=5, decay=False)]
    for hits in out[-3][:4]:
        eng.reinforce("m", hits[0]["id"])
    clock[0] = T0 + 7200.0
    out += [eng.search("m", Q, k=10),
            eng.search("m", Q[:4], k=10, columnar="np")]
    eng.configure_index("m", {"auto_links": [
        {"field": "grp", "relation": "same_grp", "max_links": 5},
        {"field": "body", "relation": "same_text", "bidirectional": True}]})
    eng.add("m", "n1", X[N], {"grp": 1, "body": metas[3]["body"]})
    eng.add("m", "n2", X[N + 1], {"grp": 3})
    edges = [eng.get_edges("m", n) for n in ("n1", "n2", "v3")]
    knobs = {"ef_search": 33, "scan_exact": True, "scan_precision": "fast",
             "int8_symmetric": True, "max_unlinked": 77}
    eng.configure_index("m", knobs)
    info = eng.index_info("m")
    beliefs = [eng.belief_state("m", n, k=5) for n in ("v1", "v10")] \
        if kind == "hnsw" else []
    return out, edges, info, beliefs


def _ids(res):
    if isinstance(res, dict):
        return res["ids"]
    return [[h["id"] for h in hits] for hits in res]


def _vals(res, key):
    if isinstance(res, dict):
        return [np.asarray(r, np.float64) for r in res[key + "s"]]
    return [np.asarray([h.get(key, np.inf) for h in hits], np.float64)
            for hits in res]


def _nan_none(rows):
    return [np.asarray([np.inf if x is None else x for x in r], np.float64)
            for r in rows]


@pytest.mark.parametrize("kind", ["hnsw", "flat"])
def test_engine_hybrid_decay_sequence_same_hits(kind, monkeypatch):
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    ref = JEngine(JEngineConfig(start_background=False)).open()
    port = Engine(EngineConfig(device="cpu", start_background=False)).open()
    fuse.fused_topk.calls = 0
    try:
        r_out, r_edges, r_info, r_bel = drive(ref, kind, clock)
        clock[0] = T0
        p_out, p_edges, p_info, p_bel = drive(port, kind, clock)
    finally:
        ref.close()
        port.close()
    # the scan-served index takes the device epilogue, the flat one the
    # host path
    assert (fuse.fused_topk.calls > 0) == (kind == "hnsw")
    for i, (r, p) in enumerate(zip(r_out, p_out)):
        assert _ids(r) == _ids(p), i
        for key in ("score", "distance"):
            rv, pv = _vals(r, key), _vals(p, key)
            if isinstance(r, dict) and key == "distance":
                rv, pv = _nan_none(r["distances"]), _nan_none(p["distances"])
            for a, b in zip(rv, pv):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    assert r_out[5]["metadata"] == p_out[5]["metadata"]
    assert r_edges == p_edges and r_edges[0] and r_edges[1]
    assert p_info["memory"] == r_info["memory"]
    for key in ("ef_search", "scan_exact", "scan_precision",
                "int8_symmetric", "max_unlinked", "serve_mode"):
        assert p_info["config"].get(key) == r_info["config"].get(key), key
    assert [vars(b) for b in p_bel] == [vars(b) for b in r_bel]


def test_decay_mirror_refreshes_in_place_on_reinforce():
    """Reinforce-on-read dirties one row per hit; the next decayed search
    refreshes the device mirror in place (no rebuild), to what a fresh
    build at the mirror's epoch would hold."""
    eng = Engine(EngineConfig(device="cpu", start_background=False)).open()
    eng.create_index("t", serve_mode="scan")
    rng = np.random.default_rng(6)
    now = time.time()
    for i in range(48):
        eng.add("t", f"v{i}", rng.normal(size=16),
                {"_created_at": now - i * 60.0, "_access_count": i % 3})
    eng.configure_index("t", {"memory": {"enabled": True,
                                         "decay_half_life": 3600.0}})
    h = eng.indexes["t"]
    q = rng.normal(size=(1, 16)).astype(np.float32)
    builds, updates = fuse.build_decay_device.calls, \
        fuse.update_decay_device.calls
    eng.search("t", q, k=3)
    assert fuse.build_decay_device.calls == builds + 1
    assert not h.meta.decay.dirty
    packed = h.decay_dev[2].packed
    for i in range(4):
        eng.reinforce("t", f"v{i}")
    eng.search("t", q, k=3)
    assert fuse.build_decay_device.calls == builds + 1
    assert fuse.update_decay_device.calls == updates + 1
    dd = h.decay_dev[2]
    assert dd.packed is packed
    np.testing.assert_array_equal(
        dd.packed.numpy(),
        fuse._pack_rows(h.meta.decay, h.memory,
                        np.arange(dd.packed.shape[0]), dd.epoch))
    eng.close()


@pytest.mark.parametrize("config", [{"serve_proj_dim": 6},
                                    {"serve_proj_rerank": 24}])
def test_configure_index_refuses_projection(config):
    """Named when the projection was refused; now the reference's toggle
    check (tests/test_engine.py::test_vconfig_serve_proj_toggle) on both
    engines: VCONFIG turns the projected read on (the arena is built) and
    off (dropped), or sets the re-rank width alone, and the top hit stays
    the query's own row."""
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(1500, 24)) * np.exp(-np.arange(24) / 5.0)
         ).astype(np.float32)
    for eng in (Engine(EngineConfig(device="cpu", start_background=False)),
                JEngine(JEngineConfig(start_background=False))):
        eng.open()
        eng.create_index("t", serve_mode="scan")
        eng.add_batch("t", [f"v{i}" for i in range(1500)], X)
        idx = eng.indexes["t"].index
        eng.configure_index("t", dict(config, ef_search=12))
        assert (idx._proj_arena() is not None) == ("serve_proj_dim" in config)
        assert idx.config.serve_proj_rerank == config.get(
            "serve_proj_rerank", 128)
        assert eng.search("t", X[5], k=1)[0][0]["id"] == "v5"
        eng.configure_index("t", {"serve_proj_dim": 0})
        assert idx._proj_arena() is None
        assert eng.search("t", X[5], k=1)[0][0]["id"] == "v5"
        assert eng.index_info("t")["config"]["ef_search"] == 12
        eng.close()
