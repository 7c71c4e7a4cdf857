"""The port's server-side query micro-batching (server/batcher.py), the
JAX package's tests/test_batcher.py.

* The reference's two cases run against the port's server: `make_app`
  over `Engine(device=DEVICE)` with a gardener, as the reference's
  `test_http.ServerFixture` builds it (the cases' source read, every
  `kektordb_tpu` module made the port's).
* Coalesced against serial: concurrent plain, filtered and hybrid
  requests, coalesced by the batcher into shared Engine.search calls,
  answer what one Engine.search per request answers, and their ids are
  the JAX package's Engine's for the same requests.
"""

import concurrent.futures as cf

import numpy as np
import requests
from test_torch_port_reference import DEVICE, reference_cases
from test_torch_server import Server

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.services.embeddings import HashingEmbedder
from kektordb_tpu_torch.services.gardener import Gardener, GardenerConfig

exec(compile(reference_cases("test_batcher.py", [
    "test_concurrent_searches_batch_and_agree",
    "test_filtered_and_text_searches_coalesce"]), "test_batcher.py", "exec"))


class ServerFixture(Server):
    """The reference's fixture over the port: an Engine on DEVICE, the
    gardener, `make_app` on 127.0.0.1:0. The cases above look the name up
    when they run, so they get this class, not test_http's."""

    def __init__(self):
        engine = Engine(EngineConfig(device=DEVICE,
                                     start_background=False)).open()
        super().__init__(engine, gardener=Gardener(
            engine, config=GardenerConfig(), embedder=HashingEmbedder()))


N, DIM = 400, 16


def _requests(X) -> list[dict]:
    """Plain, filtered and hybrid searches, 16 each."""
    out = []
    for i in range(48):
        body = {"index_name": "CS", "query_vector": X[i].tolist(), "k": 5}
        if i % 3 == 1:
            body["filter"] = "par = even" if i % 2 else "par = odd"
        elif i % 3 == 2:
            body.update(text_query="alpha", alpha=0.5)
        out.append(body)
    return out


def test_coalesced_answers_equal_serial_calls(monkeypatch):
    monkeypatch.setenv("KEKTOR_BATCH_WINDOW_MS", "120")
    rng = np.random.default_rng(4)
    X = rng.normal(size=(N, DIM)).astype(np.float32)
    metas = [{"par": "even" if i % 2 == 0 else "odd",
              "body": "alpha doc" if i < N // 2 else "beta doc",
              "_indexed_fields": ["body"]} for i in range(N)]
    srv = ServerFixture()
    ref = JEngine(JEngineConfig(start_background=False)).open()
    try:
        requests.post(srv.base + "/vector/actions/create",
                      json={"index_name": "CS", "metric": "euclidean"})
        requests.post(srv.base + "/vector/actions/add-batch", json={
            "index_name": "CS",
            "vectors": [{"id": f"v{i}", "vector": X[i].tolist(),
                         "metadata": metas[i]} for i in range(N)]})
        ref.create_index("CS")
        ref.add_batch("CS", [f"v{i}" for i in range(N)], X, metas)
        before = requests.get(srv.base + "/system/stats").json()["batcher"]
        bodies = _requests(X)

        def one(body):
            return requests.post(srv.base + "/vector/actions/search",
                                 json=body).json()
        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(one, bodies))
        after = requests.get(srv.base + "/system/stats").json()["batcher"]
        assert after["queries"] - before["queries"] == len(bodies)
        assert after["batches"] - before["batches"] <= len(bodies) // 2
        for body, res in zip(bodies, got):
            kw = {k: body[k] for k in ("filter", "text_query", "alpha")
                  if k in body}
            q = np.asarray(body["query_vector"], np.float32)
            serial = srv.engine.search("CS", q, k=5, **kw)[0]
            assert res["ids"] == [h["id"] for h in serial], body
            np.testing.assert_allclose(
                [h["score"] for h in res["results"]],
                [h["score"] for h in serial], rtol=1e-5, atol=1e-6)
            assert res["ids"] == [h["id"] for h in
                                  ref.search("CS", q, k=5, **kw)[0]], body
    finally:
        srv.stop()
        ref.close()
