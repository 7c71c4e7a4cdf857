"""Query micro-batcher — aggregates concurrent searches into device batches.

SURVEY §7.4: "the API layer must batch/queue queries into device-sized
batches (the 10× QPS win comes from batching, not per-query latency)". The
reference gets QPS only from HTTP concurrency across Go threads; here
concurrent plain vector searches against the same index coalesce into one
lockstep beam program.

Requests batch together whenever their full kwarg tuple matches —
index/k/ef plus filter string, text query, alpha, and graph restriction
(Engine.search applies one kwarg set batch-wide, so equal-kwarg requests
are exactly coalescible; a shared filter mask / BM25 pass / graph BFS is
then computed once per device batch instead of once per request). Only
per-request post-processing (relation hydration) falls through to the
direct path.

Spans (kektordb_tpu_torch/tracing.py): each request's `batcher.wait`,
from its enqueue until its batch's `Engine.search` starts, carries the
id of the `batcher.batch` span, one per flush (its `n` the queries
coalesced), under which that search's spans nest; a batch is a root of
its own, not a child of the request that opened it.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .. import tracing

log = logging.getLogger("kektordb.batcher")


@dataclass
class _Pending:
    queries: list[np.ndarray] = field(default_factory=list)
    futures: list[asyncio.Future] = field(default_factory=list)
    waits: list[tracing.Pending] = field(default_factory=list)
    timer: Optional[asyncio.TimerHandle] = None


class QueryBatcher:
    def __init__(self, engine, *, window_ms: Optional[float] = None,
                 max_batch: int = 4096):
        import os
        self.engine = engine
        if window_ms is None:
            # ops knob: longer window = more coalescing, more added
            # latency for one-off requests (default 3 ms; the device
            # dispatch itself is ~5-30 ms)
            window_ms = float(os.environ.get("KEKTOR_BATCH_WINDOW_MS", 3))
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self._pending: dict[tuple, _Pending] = {}
        self._tasks: set[asyncio.Task] = set()
        self.stats = {"batches": 0, "queries": 0, "max_batch_seen": 0}

    async def search(self, index: str, query: np.ndarray, k: int,
                     ef: Optional[int], include_metadata: bool,
                     filter: Optional[str] = None,
                     text_query: Optional[str] = None,
                     alpha: float = 0.5,
                     graph_root: Optional[str] = None,
                     graph_depth: int = 2,
                     graph_relation: Optional[str] = None
                     ) -> list[dict[str, Any]]:
        q1 = np.asarray(query, np.float32).reshape(-1)
        # zero-vector + text_query is the text-only search mode, and the
        # engine decides it per BATCH (_is_zero over the stacked queries)
        # — a text-only request must never coalesce with vector-carrying
        # requests or it silently gains a garbage vector branch
        text_only = bool(text_query) and not q1.any()
        key = (index, k, ef, include_metadata, filter, text_query, alpha,
               graph_root, graph_depth, graph_relation, text_only,
               q1.shape[0])
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        p = self._pending.get(key)
        if p is None:
            p = self._pending[key] = _Pending()
            p.timer = loop.call_later(self.window, self._flush_sync, key)
        p.queries.append(q1)
        p.futures.append(fut)
        p.waits.append(tracing.Pending("batcher.wait"))
        if len(p.queries) >= self.max_batch:
            if p.timer:
                p.timer.cancel()
            self._flush_sync(key)
        return await fut

    def _flush_sync(self, key: tuple) -> None:
        p = self._pending.pop(key, None)
        if p is None or not p.queries:
            return
        # an empty context: the batch is no request's child
        task = asyncio.get_running_loop().create_task(
            self._run(key, p), context=contextvars.Context())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run(self, key: tuple, p: _Pending) -> None:
        (index, k, ef, include_metadata, filt, text_query, alpha,
         graph_root, graph_depth, graph_relation, _text_only, _dim) = key
        self.stats["batches"] += 1
        self.stats["queries"] += len(p.queries)
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                           len(p.queries))
        started = []

        def search():
            started.append(tracing.now())
            return self.engine.search(
                index, q, k=k, ef=ef, include_metadata=include_metadata,
                filter=filt, text_query=text_query, alpha=alpha,
                graph_root=graph_root, graph_depth=graph_depth,
                graph_relation=graph_relation)

        with tracing.span("batcher.batch", n=len(p.queries)) as batch:
            try:
                # inside try: any failure (incl. stacking) must fan out to
                # the futures — an escaped exception would leave every
                # request in the batch awaiting forever
                q = np.stack(p.queries)
                results = await asyncio.to_thread(search)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for f in p.futures:
                    if not f.done():
                        f.set_exception(e)
                return
            finally:
                at = started[0] if started else None
                for w in p.waits:
                    w.end(at, link=batch.id)
        for f, hits in zip(p.futures, results):
            if not f.done():
                f.set_result(hits)
