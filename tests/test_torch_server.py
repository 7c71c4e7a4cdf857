"""The port's HTTP server (kektordb_tpu_torch/server) over
`Engine(device="cpu")`, held to the JAX package's.

* every step of testdata/contracts.json passes, each step a test;
* the port's `make_app` has the reference's routes, (method, path) for
  (method, path);
* one request stream goes to both servers (create, add-batch, plain,
  batched, columnar and b64 searches, search-with-scores, the graph, KV
  and a host index): the same JSON, ids equal, floats within 1e-5,
  relative or absolute (the packages' f32 sums run in other orders, and
  the min-max scores in [0, 1] carry a distance's error times
  d / (d_max - d_min));
* the host index keeps its auto projection through the API, the
  auth-enabled server, and `/debug/profile` writing a torch.profiler
  trace.
"""

import asyncio
import base64
import json
import math
import os
import threading
import time

import numpy as np
import pytest
import requests
import torch

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu.server import make_app as jmake_app
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index.hostarena import HostArenaIndex
from kektordb_tpu_torch.server import make_app
from kektordb_tpu_torch.services.embeddings import HashingEmbedder
from kektordb_tpu_torch.services.gardener import Gardener, GardenerConfig

CONTRACTS = os.path.join(os.path.dirname(__file__), "..", "testdata",
                         "contracts.json")
RTOL = 1e-5


class Server:
    """An aiohttp app from `make_app(engine, **kw)` on 127.0.0.1:0, served
    by an event loop in a daemon thread."""

    def __init__(self, engine, app_factory=make_app, **kw):
        from aiohttp import web
        self.engine = engine
        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        holder = {}

        async def start():
            runner = web.AppRunner(app_factory(engine, **kw))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            holder["port"] = site._server.sockets[0].getsockname()[1]
            holder["runner"] = runner
            started.set()

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(start())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        assert started.wait(30), "server failed to start"
        self._runner = holder["runner"]
        self.base = f"http://127.0.0.1:{holder['port']}"

    def stop(self):
        fut = asyncio.run_coroutine_threadsafe(self._runner.cleanup(),
                                               self._loop)
        fut.result(timeout=30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30)
        assert not self._thread.is_alive()


def port_engine():
    return Engine(EngineConfig(device="cpu", start_background=False)).open()


@pytest.fixture(scope="module")
def srv():
    eng = port_engine()
    gardener = Gardener(eng, config=GardenerConfig(),
                        embedder=HashingEmbedder())
    s = Server(eng, gardener=gardener)
    yield s
    s.stop()
    eng.close()


def load_steps():
    with open(CONTRACTS) as f:
        return json.load(f)["steps"]


@pytest.mark.parametrize("step", load_steps(), ids=lambda s: s["id"])
def test_contract(step, srv):
    """The contract runner of tests/test_contracts.py, against the port."""
    url = srv.base + step["path"]
    kw = {}
    if "body" in step:
        kw["json"] = step["body"]
    elif "raw_body" in step:
        kw["data"] = step["raw_body"].encode()
    r = requests.request(step["method"], url, timeout=60, **kw)
    assert r.status_code == step["expect_status"], \
        f"{step['id']}: got {r.status_code}, body={r.text[:200]}"
    if r.status_code == 204 or not r.content:
        return
    data = r.json() if "json" in r.headers.get("Content-Type", "") else None
    if data is None:
        return
    if step.get("expect_type") == "array":
        assert isinstance(data, list)
        return
    for f in step.get("expect_fields", []):
        assert f in data, f"{step['id']}: missing field {f}"
    for k, v in (step.get("expect_equals") or {}).items():
        assert data.get(k) == v, f"{step['id']}: {k}={data.get(k)!r} != {v!r}"
    if "expect_contains_name" in step:
        assert any(i.get("name") == step["expect_contains_name"]
                   for i in data)
    if step.get("expect_ids_b64_count_matches_shape"):
        flat = base64.b64decode(data["ids_b64"]).decode().split("\n")
        want = data["shape"][0] * data["shape"][1]
        assert len(flat) == want, \
            f"{step['id']}: ids_b64 decoded to {len(flat)} ids, want {want}"
    if "expect_first_id" in step:
        assert data["ids"][0] == step["expect_first_id"]
    if "expect_ids_subset" in step:
        assert set(data["ids"]) <= set(step["expect_ids_subset"])


def _routes(app):
    out = set()
    for route in app.router.routes():
        info = route.resource.get_info() if route.resource else {}
        out.add((route.method, info.get("path") or info.get("formatter")
                 or info.get("prefix")))
    return out


def test_routes_equal_reference():
    jeng = JEngine(JEngineConfig(start_background=False)).open()
    eng = port_engine()
    want, got = _routes(jmake_app(jeng)), _routes(make_app(eng))
    assert len(got) >= 80
    assert got == want, (sorted(want - got), sorted(got - want))
    eng.close()
    jeng.close()


def _b64(a):
    return base64.b64encode(np.asarray(a, "<f4").tobytes()).decode()


def _stream():
    """(method, path, body) requests, one stream for both servers."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(240, 16)).astype(np.float32)
    Q = rng.normal(size=(6, 16)).astype(np.float32)
    H = rng.normal(size=(3000, 32)).astype(np.float32)
    # fresh queries: a query equal to a row puts its distance, a
    # difference of nearly equal sums, at the f32 noise floor
    QH = rng.normal(size=(5, 32)).astype(np.float32)
    s = [("POST", "/vector/actions/create",
          {"index_name": "D", "metric": "euclidean",
           "serve_mode": "scan"}),
         ("POST", "/vector/actions/add-batch",
          {"index_name": "D", "vectors": [
              {"id": f"d{i}", "vector": X[i].tolist(),
               "metadata": {"grp": i % 3, "content": f"note {i}"}}
              for i in range(240)]}),
         ("POST", "/vector/actions/search",
          {"index_name": "D", "query_vector": Q[0].tolist(), "k": 5}),
         ("POST", "/vector/actions/search",
          {"index_name": "D", "query_vector": Q[1].tolist(), "k": 5,
           "filter": "grp = 1"}),
         ("POST", "/vector/actions/search",
          {"index_name": "D", "query_vectors": Q.tolist(), "k": 4}),
         ("POST", "/vector/actions/search",
          {"index_name": "D", "query_vectors": Q.tolist(), "k": 4,
           "columnar": True}),
         ("POST", "/vector/actions/search",
          {"index_name": "D", "k": 4, "columnar": True, "wire": "b64",
           "query_vectors_b64": _b64(Q), "query_shape": [6, 16]}),
         ("POST", "/vector/actions/search-with-scores",
          {"index_name": "D", "query_vector": Q[2].tolist(), "k": 3}),
         ("GET", "/vector/indexes/D/vectors/d7", None),
         ("POST", "/graph/actions/link",
          {"index_name": "D", "source_id": "d1", "target_id": "d2",
           "relation_type": "rel", "inverse_relation_type": "rel_inv"}),
         ("POST", "/graph/actions/link",
          {"index_name": "D", "source_id": "d2", "target_id": "d3",
           "relation_type": "rel"}),
         ("POST", "/graph/actions/get-links",
          {"index_name": "D", "source_id": "d1", "relation_type": "rel"}),
         ("POST", "/graph/actions/find-path",
          {"index_name": "D", "source_id": "d1", "target_id": "d3"}),
         ("POST", "/vector/actions/search",
          {"index_name": "D", "query_vector": Q[3].tolist(), "k": 3,
           "graph_root": "d1", "graph_depth": 2}),
         ("POST", "/kv/alpha", {"value": "one"}),
         ("GET", "/kv/alpha", None),
         ("DELETE", "/kv/alpha", None),
         ("GET", "/kv/alpha", None),
         ("POST", "/vector/actions/create",
          {"index_name": "H", "metric": "euclidean", "kind": "host",
           "serve_proj_dim": 0}),
         ("POST", "/vector/actions/add-batch",
          {"index_name": "H", "vectors": [
              {"id": f"h{i}", "vector": H[i].tolist(),
               "metadata": {"par": i % 2}} for i in range(3000)]}),
         ("POST", "/vector/actions/search",
          {"index_name": "H", "query_vectors": QH.tolist(), "k": 4,
           "columnar": True}),
         ("POST", "/vector/actions/search",
          {"index_name": "H", "query_vector": QH[0].tolist(),
           "k": 6, "filter": "par = 1"}),
         ("POST", "/vector/actions/delete",
          {"index_name": "H", "id": "h4"}),
         ("POST", "/vector/actions/search",
          {"index_name": "H", "query_vector": QH[1].tolist(), "k": 2}),
         ("GET", "/vector/indexes/H", None)]
    return s


# fields that carry a wall-clock time or a process-local id
_VOLATILE = {"created_at", "_created_at", "updated_at", "uptime_s",
             "timestamp", "last_accessed", "_last_accessed", "memory_report",
             "mask_cache", "started_at"}


def _same(a, b, where=""):
    if isinstance(a, dict) and isinstance(b, dict):
        assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
        for k in a:
            if k not in _VOLATILE:
                _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=RTOL), (where, a, b)
    elif isinstance(a, str) and where.endswith("_b64") \
            and not where.endswith("ids_b64"):
        x = np.frombuffer(base64.b64decode(a), "<f4")
        y = np.frombuffer(base64.b64decode(b), "<f4")
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=RTOL, err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_differential_request_stream():
    """The same requests to the reference's server and the port's: the
    same status codes and JSON."""
    jeng = JEngine(JEngineConfig(start_background=False)).open()
    eng = port_engine()
    ref, got = Server(jeng, jmake_app), Server(eng)
    try:
        for method, path, body in _stream():
            kw = {"json": body} if body is not None else {}
            a = requests.request(method, ref.base + path, timeout=120, **kw)
            b = requests.request(method, got.base + path, timeout=120, **kw)
            assert a.status_code == b.status_code, (path, a.text, b.text)
            if "json" in a.headers.get("Content-Type", ""):
                _same(a.json(), b.json(), f"{method} {path}")
        assert isinstance(eng.indexes["H"].index, HostArenaIndex)
    finally:
        ref.stop()
        got.stop()
        eng.close()
        jeng.close()


def test_host_index_keeps_auto_proj_via_api(srv):
    """A server-created host index with no serve_proj_dim keeps the auto
    projected mirror (absent is not an explicit 0)."""
    body = {"index_name": "HOSTAUTO", "metric": "euclidean",
            "precision": "float32", "kind": "host"}
    assert requests.post(srv.base + "/vector/actions/create",
                         json=body).status_code == 200
    v = np.zeros(64, np.float32)
    v[0] = 1.0
    assert requests.post(
        srv.base + "/vector/actions/add",
        json={"index_name": "HOSTAUTO", "id": "a",
              "vector": v.tolist()}).status_code == 200
    h = srv.engine.indexes["HOSTAUTO"]
    assert isinstance(h.index, HostArenaIndex) and h.index._proj_auto
    assert requests.post(
        srv.base + "/vector/actions/create",
        json={"index_name": "HOSTFULL", "metric": "euclidean",
              "precision": "float32", "kind": "host",
              "serve_proj_dim": 0}).status_code == 200
    assert requests.post(
        srv.base + "/vector/actions/add",
        json={"index_name": "HOSTFULL", "id": "a",
              "vector": v.tolist()}).status_code == 200
    assert srv.engine.indexes["HOSTFULL"].index._proj_auto is False


def test_auth_enabled_server():
    eng = port_engine()
    s = Server(eng, token="root-secret")
    base = s.base
    try:
        assert requests.get(base + "/healthz").status_code == 200
        assert requests.get(base + "/system/stats").status_code == 401
        root = {"Authorization": "Bearer root-secret"}
        assert requests.get(base + "/system/stats",
                            headers=root).status_code == 200
        r = requests.post(base + "/auth/keys", headers=root,
                          json={"role": "read", "name": "ro"})
        ro = {"Authorization": "Bearer " + r.json()["token"]}
        assert requests.get(base + "/vector/indexes",
                            headers=ro).status_code == 200
        assert requests.post(base + "/vector/actions/create", headers=ro,
                             json={"index_name": "X"}).status_code == 403
        requests.delete(base + "/auth/keys/" + r.json()["id"], headers=root)
        assert requests.get(base + "/vector/indexes",
                            headers=ro).status_code == 401
    finally:
        s.stop()
        eng.close()


def test_debug_profile_writes_torch_trace(srv):
    """/debug/profile runs torch.profiler for the given seconds and writes
    a Chrome trace into its directory; the task reports it done."""
    requests.post(srv.base + "/vector/actions/create",
                  json={"index_name": "PROF", "kind": "flat"})
    requests.post(srv.base + "/vector/actions/add",
                  json={"index_name": "PROF", "id": "a",
                        "vector": [1.0, 0.0, 0.0]})
    r = requests.post(srv.base + "/debug/profile?seconds=0.3")
    assert r.status_code == 202, r.text
    out = r.json()
    # search until the profile is done, so that some search runs while
    # the profiler is on however late its thread starts
    deadline = time.time() + 60
    while time.time() < deadline:
        requests.post(srv.base + "/vector/actions/search",
                      json={"index_name": "PROF",
                            "query_vector": [1.0, 0.0, 0.0], "k": 1})
        t = requests.get(srv.base + "/system/tasks/" + out["task_id"]).json()
        if t["status"] in ("completed", "failed"):
            break
    assert t["status"] == "completed", t
    path = os.path.join(out["trace_dir"], "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert "traceEvents" in trace
    # the program's spans are named ranges of the trace (tracing.py)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"http.request", "engine.search"} <= names
    assert torch.cuda.is_available() or all(
        e.get("cat") != "kernel" for e in trace["traceEvents"])
