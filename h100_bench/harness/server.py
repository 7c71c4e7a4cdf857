"""The program under test, set up as `python -m kektordb_tpu_torch serve`
sets it up: an in-memory Engine (no data directory) with its background
thread, the services `build_services` makes from an empty configuration,
and the aiohttp app of `server/http.make_app`, served on 127.0.0.1 from a
thread of this process.

The collection is loaded before the services are built, as `serve`
finds it when it opens a data directory that holds it: the services'
artifact watcher subscribes to the Engine's events when it is built, and
then scans every row's metadata for each event it takes, which makes a
bulk load through `add_batch` quadratic in the rows (a million rows do
not load within a run's time).

One departure, on purpose: `serve` also starts the services' background
loop, whose gardener thinks over every index at its first tick and again
after 50 writes; at this collection's size that pass lands at a random
point of a window. The benchmark leaves it off and measures the read
path.
"""

from __future__ import annotations

import asyncio
import http.client
import threading

import numpy as np

INDEX = "bench"
ADD_CHUNK = 1 << 17


class Served:
    def __init__(self, cfg: dict, device: str):
        from kektordb_tpu_torch.engine import Engine, EngineConfig

        self.engine = Engine(EngineConfig(device=device)).open()
        self.services = None
        ix = cfg["index"]
        self.engine.create_index(INDEX, metric=ix["metric"],
                                 precision=ix["precision"], kind=ix["kind"],
                                 serve_mode=ix["serve_mode"])
        self.port = 0
        self._loop = None
        self._thread = None
        self._runner = None

    def load(self, rows: np.ndarray, texts=None, field: str = "text"
             ) -> None:
        """Rows through `Engine.add_batch`, ids the row numbers as
        decimal strings; each text, where given, as an indexed field."""
        for s in range(0, rows.shape[0], ADD_CHUNK):
            e = min(s + ADD_CHUNK, rows.shape[0])
            metas = None
            if texts is not None:
                metas = [{field: t, "_indexed_fields": [field]}
                         for t in texts[s:e]]
            self.engine.add_batch(INDEX, [str(i) for i in range(s, e)],
                                  rows[s:e], metas)

    def start(self) -> None:
        """Build the services and the app and serve them."""
        from aiohttp import web

        from kektordb_tpu_torch.server.config import build_services
        from kektordb_tpu_torch.server.http import make_app

        svc = self.services = build_services(self.engine, {})
        app = make_app(self.engine, token=None, embedder=svc["embedder"],
                       gardener=svc["gardener"], compiler=svc["compiler"],
                       rag=svc["rag"], vectorizers=svc["vectorizers"])
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        async def boot():
            self._runner = web.AppRunner(app, access_log=None)
            await self._runner.setup()
            site = web.TCPSite(self._runner, "127.0.0.1", 0)
            await site.start()
            self.port = self._runner.addresses[0][1]

        def serve():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(boot())
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=serve, daemon=True)
        self._thread.start()
        if not started.wait(60):
            raise RuntimeError("the server did not start")

    def request(self, route: str, body: bytes) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        try:
            conn.request("POST", route, body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def stop(self) -> None:
        """Stop serving, close the Engine and let go of its state."""
        if self._loop is not None:
            fut = asyncio.run_coroutine_threadsafe(self._runner.cleanup(),
                                                   self._loop)
            fut.result(60)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(60)
            self._loop.close()
            self._loop = None
        if self.engine is not None:
            self.engine.close()
            self.engine = None
            self.services = None
