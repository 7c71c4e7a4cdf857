"""Background service loop — the daemon side of the services layer.

Reference behaviors combined here: the Gardener's adaptive think scheduling
(gardener.go:150-190 — early think after N writes, else interval), the
vectorizer file watchers (internal/server/vectorizer_service.go), the
artifact archive sweep (watcher.go 30-day archive), and the gateway's
semantic-cache vacuum (proxy.go:754). Engine-level persistence/maintenance
tickers live in Engine._background (engine.py); this loop owns the
service-level ones."""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger("kektordb.services")


class ServiceLoop:
    TICK = 5.0

    def __init__(self, engine, *, gardener=None, vectorizers=None,
                 compiler=None, gateway=None,
                 vectorizer_interval: float = 60.0,
                 archive_interval: float = 6 * 3600.0,
                 cache_vacuum_interval: float = 600.0):
        self.engine = engine
        self.gardener = gardener
        self.vectorizers = vectorizers
        self.compiler = compiler
        self.gateway = gateway
        self.vectorizer_interval = vectorizer_interval
        self.archive_interval = archive_interval
        self.cache_vacuum_interval = cache_vacuum_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServiceLoop":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        last_vec = last_archive = last_vacuum = time.time()
        while not self._stop.wait(self.TICK):
            now = time.time()
            try:
                if self.gardener is not None:
                    for name in list(self.engine.indexes):
                        if self.gardener.should_think(name):
                            self.gardener.think(name)
                if self.vectorizers is not None and \
                        now - last_vec >= self.vectorizer_interval:
                    last_vec = now
                    for p in list(self.vectorizers.pipelines.values()):
                        try:
                            self.vectorizers.ingest_dir(p)
                        except Exception:
                            log.exception("vectorizer %s failed", p.name)
                if self.compiler is not None and \
                        now - last_archive >= self.archive_interval:
                    last_archive = now
                    self.compiler.sweep_archive()
                if self.gateway is not None and \
                        now - last_vacuum >= self.cache_vacuum_interval:
                    last_vacuum = now
                    self.gateway.cache_vacuum()
            except Exception:   # pragma: no cover — keep the daemon alive
                log.exception("service loop error")
