"""HTTP REST API (aiohttp) — the reference's ~60-route surface.

Reference: internal/server/http_handlers.go:45-161 route table,
http_types.go DTOs (field names preserved: index_name, query_vector,
relation_type, ...), middleware chain Recovery→Logging→BodyLimit→Auth
(server.go:111-124), api_contracts.json status-code contracts (409 on
duplicate index/id, 404 on missing, 400 on self-link, 204 on index delete).

Blocking engine work runs in a thread pool (`asyncio.to_thread`) so the
event loop keeps serving; the engine itself serializes writes.
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
import logging
import os
import time
import uuid
from typing import Any, Optional

import numpy as np
from aiohttp import web

from ..engine.engine import Engine
from ..engine import fusion
from . import auth as authlib
from .metrics import Metrics
from .tasks import TaskManager

log = logging.getLogger("kektordb.http")

MAX_BODY = 512 * 1024 * 1024


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status)


def _err(msg: str, status: int) -> web.Response:
    return web.json_response({"error": msg}, status=status)


def _status_of(exc: Exception) -> int:
    msg = str(exc)
    if isinstance(exc, KeyError):
        return 409 if "already" in msg else 404
    if isinstance(exc, ValueError):
        return 400
    return 500


def make_app(engine: Engine, *,
             token: Optional[str] = None,
             embedder=None,
             gardener=None,
             compiler=None,
             rag=None,
             vectorizers=None) -> web.Application:
    metrics = Metrics()
    tasks = TaskManager()
    auth_svc = authlib.AuthService(engine.kv) if token else None
    sessions: dict[str, dict] = {}
    from .batcher import QueryBatcher
    batcher = QueryBatcher(engine)

    # ------------------------------------------------------------ middleware

    @web.middleware
    async def mw_recovery(request, handler):
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except KeyError as e:
            return _err(str(e).strip("'"), _status_of(e))
        except ValueError as e:
            return _err(str(e), 400)
        except Exception as e:  # noqa: BLE001 - recovery middleware
            log.exception("handler error")
            return _err(str(e), 500)

    @web.middleware
    async def mw_metrics(request, handler):
        t0 = time.monotonic()
        resp = await handler(request)
        metrics.observe(request.method, request.path, resp.status,
                        time.monotonic() - t0)
        return resp

    @web.middleware
    async def mw_auth(request, handler):
        if auth_svc is None or request.path in ("/healthz", "/metrics"):
            return await handler(request)
        hdr = request.headers.get("Authorization", "")
        bearer = hdr[7:] if hdr.startswith("Bearer ") else ""
        if token and bearer == token:
            return await handler(request)     # root token
        claims = auth_svc.verify_token(bearer) if bearer else None
        if claims is None:
            return _err("unauthorized", 401)
        need = authlib.required_role(request.method, request.path)
        if not authlib.role_allows(claims.get("role", ""), need):
            return _err("forbidden", 403)
        body = None
        if request.can_read_body and \
                request.content_type == "application/json":
            try:
                body = await request.json()
                request["json"] = body
            except Exception:
                body = None
        ns = authlib.namespace_of(request.path, body)
        if not authlib.namespace_allowed(claims, ns):
            return _err("forbidden namespace", 403)
        return await handler(request)

    app = web.Application(middlewares=[mw_recovery, mw_metrics, mw_auth],
                          client_max_size=MAX_BODY)

    async def body_of(request) -> dict:
        if "json" in request:
            return request["json"]
        try:
            raw = await request.read()
            # Thread the parse only when it is actually expensive: many
            # JSON VALUES (batched query_vectors: 100k+ floats), not many
            # bytes — a b64-wire body is one ~700KB string that parses in
            # ~1 ms, and routing it through asyncio.to_thread cost the
            # colocated single-client bench 36% (BENCH_r04 http_b64_qps
            # regression). Comma count is a memchr-speed proxy for value
            # count; parsing on the event loop serializes ALL concurrent
            # requests behind one parse, while in a thread it overlaps
            # other requests' device waits (which release the GIL). The
            # win only materializes with >1 host core; the measured
            # multi-process capacity number is http_multiclient_qps
            # (NOTES.md "16-way concurrency claim RETRACTED").
            if len(raw) > 65536 and raw.count(b",") > 4096:
                return await asyncio.to_thread(json.loads, raw)
            return json.loads(raw)
        except Exception as e:
            raise ValueError(f"invalid JSON body: {e}") from e

    def hits_to_results(hits: list[dict]) -> list[dict]:
        # single pass over the engine's hit dicts: add the always-present
        # score/distance keys in place instead of rebuilding every dict
        # (the rebuild cost ~25% of plain-wire serialization at B=1024)
        for h in hits:
            h.setdefault("score", None)
            h.setdefault("distance", None)
        return hits

    # ------------------------------------------------------------- system

    async def healthz(request):
        return _json({"status": "ok"})

    async def system_save(request):
        path = await asyncio.to_thread(engine.save_snapshot)
        return _json({"status": "ok", "checkpoint": path})

    async def system_aof_rewrite(request):
        # snapshot + truncate IS the compacted journal in this design
        path = await asyncio.to_thread(engine.save_snapshot)
        return _json({"status": "ok", "checkpoint": path})

    async def system_stats(request):
        st = await asyncio.to_thread(engine.stats)
        metrics.vectors_total = sum(
            i["size"] for i in st["indexes"].values())
        st["batcher"] = dict(batcher.stats)
        return _json(st)

    async def system_task(request):
        t = tasks.get(request.match_info["id"])
        if t is None:
            return _err("no such task", 404)
        return _json(t.to_dict())

    async def system_gardener(request):
        if gardener is None:
            return _json({"enabled": False})
        return _json(gardener.status())

    async def embedder_status(request):
        if embedder is None:
            return _json({"status": "disabled", "provider": "none"})
        return _json(embedder.status())

    async def embedder_reload(request):
        if embedder is None:
            return _err("no embedder configured", 400)
        await asyncio.to_thread(embedder.reload)
        return _json({"status": "ok"})

    async def vectorizers_list(request):
        if vectorizers is None:
            return _json([])
        return _json(vectorizers.list())

    async def vectorizers_trigger(request):
        if vectorizers is None:
            return _err("no vectorizers configured", 404)
        name = request.match_info["name"]
        t = tasks.submit(f"vectorize:{name}",
                         lambda: vectorizers.trigger(name))
        return _json({"status": "started", "task_id": t.id}, 202)

    async def metrics_route(request):
        return web.Response(text=metrics.render(),
                            content_type="text/plain", charset="utf-8")

    async def events_stream(request):
        """SSE fed by the EventBus (http_handlers.go:61, events.go:68)."""
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache"})
        await resp.prepare(request)
        sid, q = engine.events.subscribe()
        try:
            while True:
                try:
                    ev = await asyncio.to_thread(q.get, True, 15.0)
                    data = json.dumps({
                        "type": ev.type, "index": ev.index,
                        "id": ev.node_id, "payload": ev.payload,
                        "ts": ev.ts})
                    await resp.write(
                        f"event: {ev.type}\ndata: {data}\n\n".encode())
                except Exception:
                    await resp.write(b": keepalive\n\n")
        finally:
            engine.events.unsubscribe(sid)
        return resp

    # ----------------------------------------------------------------- KV

    async def kv_get(request):
        v = engine.kv_get(request.match_info["key"])
        if v is None:
            return _err("key not found", 404)
        return web.Response(body=v, content_type="application/octet-stream")

    async def kv_set(request):
        val = await request.read()
        await asyncio.to_thread(engine.kv_set,
                                request.match_info["key"], val)
        return _json({"status": "ok"})

    async def kv_delete(request):
        ok = await asyncio.to_thread(engine.kv_delete,
                                     request.match_info["key"])
        if not ok:
            return _err("key not found", 404)
        return _json({"status": "ok"})

    # ------------------------------------------------------------- indexes

    async def indexes_list(request):
        out = []
        for name in engine.list_indexes():
            info = engine.index_info(name)
            out.append({"name": name, "metric": info["metric"],
                        "precision": info["precision"],
                        "vector_count": info["size"]})
        return _json(out)

    async def index_create(request):
        b = await body_of(request)
        name = b.get("index_name") or b.get("name")
        if not name:
            raise ValueError("index_name required")
        try:
            await asyncio.to_thread(
                engine.create_index, name,
                metric=b.get("metric", "euclidean"),
                precision=b.get("precision", "float32"),
                m=int(b.get("m", 16)),
                ef_construction=int(b.get("ef_construction", 200)),
                ef_search=int(b.get("ef_search", 100)),
                language=b.get("text_language", "english"),
                seed=int(b.get("seed", 42)),
                kind=b.get("kind", "hnsw"),
                # absent != explicit 0: None lets host arenas keep the
                # auto projected-mirror default; 0 forces full-dim
                serve_proj_dim=(int(b["serve_proj_dim"])
                                if "serve_proj_dim" in b else None),
                serve_proj_rerank=int(b.get("serve_proj_rerank", 128)),
                shards=int(b.get("shards", 0)),
                serve_mode=b.get("serve_mode", "auto"))
        except KeyError as e:
            return _err(str(e).strip("'"), 409)
        except ValueError as e:
            return _err(str(e), 400)
        return _json({"status": "ok", "index": name})

    async def index_get(request):
        name = request.match_info["name"]
        if name not in engine.indexes:
            return _err(f"no such index: {name}", 404)
        info = engine.index_info(name)
        info["vector_count"] = info["size"]
        return _json(info)

    async def index_delete(request):
        name = request.match_info["name"]
        try:
            await asyncio.to_thread(engine.drop_index, name)
        except KeyError:
            return _err(f"no such index: {name}", 404)
        return web.Response(status=204)

    async def index_config(request):
        name = request.match_info["name"]
        b = await body_of(request)
        await asyncio.to_thread(engine.configure_index, name, b)
        return _json({"status": "ok"})

    async def index_maintenance(request):
        name = request.match_info["name"]
        b = await body_of(request) if request.can_read_body else {}
        kind = (b or {}).get("type", "refine")
        h = engine._handle(name)

        def run():
            if kind == "vacuum":
                return {"purged": h.index.vacuum()}
            h.index.refine_step()
            return {"refined": True}

        t = tasks.submit(f"maintenance:{kind}", run)
        return _json({"status": "started", "task_id": t.id}, 202)

    async def auto_links_put(request):
        name = request.match_info["name"]
        b = await body_of(request)
        await asyncio.to_thread(engine.configure_index, name,
                                {"auto_links": b.get("rules", [])})
        return _json({"status": "ok"})

    async def auto_links_get(request):
        h = engine._handle(request.match_info["name"])
        from dataclasses import asdict
        return _json({"rules": [asdict(r) for r in h.auto_links]})

    async def index_export(request):
        name = request.match_info["name"]
        h = engine._handle(name)
        limit = int(request.query.get("limit", 100))
        offset = int(request.query.get("offset", 0))
        idx = h.index
        if hasattr(idx, "flush"):
            idx.flush()
        ids = sorted(idx.ids.ext_to_row)[offset:offset + limit]
        out = []
        for e in ids:
            vec = idx.get_vector(e) if hasattr(idx, "get_vector") else None
            row = idx.ids.get(e)
            out.append({"id": e,
                        "vector": vec.tolist() if vec is not None else None,
                        "metadata": h.meta.get(row) or {}})
        return _json({"vectors": out, "total": len(idx.ids.ext_to_row),
                      "offset": offset, "limit": limit})

    # ------------------------------------------------------------- vectors

    async def vector_add(request):
        b = await body_of(request)
        try:
            await asyncio.to_thread(
                engine.add, b["index_name"], b["id"],
                np.asarray(b["vector"], np.float32),
                b.get("metadata"))
        except KeyError as e:
            msg = str(e).strip("'")
            return _err(msg, 409 if "already" in msg else 404)
        return _json({"status": "ok"})

    async def vector_add_batch(request):
        b = await body_of(request)
        items = b.get("vectors") or []
        if not items:
            return _json({"status": "ok", "count": 0})
        ids = [it["id"] for it in items]
        vecs = np.asarray([it["vector"] for it in items], np.float32)
        metas = [it.get("metadata") for it in items]
        await asyncio.to_thread(engine.add_batch, b["index_name"],
                                ids, vecs, metas)
        return _json({"status": "ok", "count": len(ids)})

    async def vector_import(request):
        b = await body_of(request)
        items = b.get("vectors") or []
        ids = [it["id"] for it in items]
        vecs = np.asarray([it["vector"] for it in items], np.float32) \
            if items else np.zeros((0, 1), np.float32)
        metas = [it.get("metadata") for it in items]

        def run():
            engine.add_batch(b["index_name"], ids, vecs, metas,
                             fast=True, _journal=False)
            return {"imported": len(ids)}

        t = tasks.submit("import", run)
        return _json({"status": "started", "task_id": t.id}, 202)

    async def vector_import_commit(request):
        b = await body_of(request)
        h = engine._handle(b["index_name"])

        def run():
            if hasattr(h.index, "turbo_refine"):
                h.index.turbo_refine()
            engine.save_snapshot()
            return {"status": "committed"}

        t = tasks.submit("import-commit", run)
        return _json({"status": "started", "task_id": t.id}, 202)

    async def vector_search(request):
        """Search: query_vector | query_text (embedded) | text_query alone
        (text-only BM25); batched via query_vectors/query_vectors_b64."""
        b = await body_of(request)
        name = b["index_name"]
        qvs = b.get("query_vectors")
        if b.get("query_vectors_b64"):
            # binary query ingestion: base64 raw little-endian f32, row-major
            # [B, D] (query_shape) — skips JSON float parsing for large
            # batches (65k numbers per 512x128 request otherwise)
            raw = base64.b64decode(b["query_vectors_b64"])
            shape = b.get("query_shape")
            if not shape or len(shape) != 2:
                raise ValueError("query_shape [B, D] required with "
                                 "query_vectors_b64")
            qvs = np.frombuffer(raw, dtype="<f4").reshape(shape)
        if qvs is not None and len(qvs):
            # batched search: one request carries [B, D] queries and gets
            # per-query hit lists back — the serving-throughput API the
            # per-query reference HTTP surface lacks (BENCHMARKS.md:7-15
            # measures sequential single-query clients)
            q = np.asarray(qvs, np.float32)
            gf = b.get("graph_filter") or {}
            columnar = bool(b.get("columnar"))
            # wire="b64": scores/distances leave as base64 raw f32 instead
            # of JSON numbers (8x faster to serialize AND parse at B=2048;
            # ragged results fall back to list columnar — clients detect
            # by the scores_b64 key)
            wire_b64 = columnar and b.get("wire") == "b64"

            def work() -> bytes:
                # search AND serialize in the worker thread: large batched
                # responses must not serialize on the event loop (it would
                # block request intake and kill cross-request pipelining)
                hits = engine.search(
                    name, q, k=int(b.get("k", 10)),
                    ef=b.get("ef_search") or None,
                    filter=b.get("filter") or None,
                    text_query=b.get("text_query") or None,
                    alpha=float(b.get("alpha", 0.5)),
                    graph_root=gf.get("root_id"),
                    graph_depth=int(gf.get("depth", 2)),
                    graph_relation=gf.get("relation"),
                    include_metadata=bool(b.get("hydrate")),
                    columnar="np" if wire_b64 else columnar)
                if columnar:
                    if wire_b64 and isinstance(hits.get("scores"),
                                               np.ndarray):
                        sc, di = hits["scores"], hits["distances"]
                        payload = {
                            "scores_b64": base64.b64encode(
                                sc.astype("<f4").tobytes()).decode(),
                            "distances_b64": base64.b64encode(
                                di.astype("<f4").tobytes()).decode(),
                            "shape": list(sc.shape)}
                        # ids ride the binary wire too: one
                        # newline-joined UTF-8 blob beats json.dumps of
                        # B*k short strings (~3 ms per 2048-query
                        # response), the last host serialization cost on
                        # this path. Falls back to the JSON array when an
                        # id embeds a newline or is non-string.
                        flat = list(itertools.chain.from_iterable(
                            hits["ids"]))
                        try:
                            joined = "\n".join(flat)
                            rect_ok = (flat and joined.count("\n")
                                       == len(flat) - 1
                                       and len(flat)
                                       == sc.shape[0] * sc.shape[1])
                        except TypeError:
                            rect_ok = False
                        if rect_ok:
                            payload["ids_b64"] = base64.b64encode(
                                joined.encode()).decode()
                        else:
                            payload["ids"] = hits["ids"]
                        return json.dumps(payload).encode()
                    # parallel [B][<=k] arrays — ~3x fewer JSON bytes and
                    # no per-hit dicts on either side of the wire
                    return json.dumps(hits).encode()
                return json.dumps(
                    {"results_batch":
                     [hits_to_results(h) for h in hits]}).encode()

            body = await asyncio.to_thread(work)
            return web.Response(body=body,
                                content_type="application/json")
        qv = b.get("query_vector")
        if not qv and b.get("query_text") and embedder is not None:
            qv = await asyncio.to_thread(embedder.embed, b["query_text"])
        if qv is None and b.get("text_query"):
            # text-only search (reference ops.go:896 text-only path): a
            # zero query vector makes the engine skip the vector branch
            # and rank by BM25 alone
            h = engine._handle(name)
            qv = [0.0] * int(h.index.dim or 1)
        if qv is None:
            raise ValueError(
                "query_vector, query_text, or text_query required")
        gf = b.get("graph_filter") or {}
        batchable = not (b.get("hydrate_relations")
                         or b.get("include_relations"))
        if batchable:
            # coalesce concurrent equal-kwarg requests into one device
            # batch — shared filter mask / BM25 pass / graph BFS computed
            # once per batch (server/batcher.py)
            res = await batcher.search(
                name, np.asarray(qv, np.float32), int(b.get("k", 10)),
                b.get("ef_search") or None, bool(b.get("hydrate")),
                filter=b.get("filter") or None,
                text_query=b.get("text_query") or None,
                alpha=float(b.get("alpha", 0.5)),
                graph_root=gf.get("root_id"),
                graph_depth=int(gf.get("depth", 2)),
                graph_relation=gf.get("relation"))
            return _json({"results": hits_to_results(res),
                          "ids": [h["id"] for h in res]})
        hits = await asyncio.to_thread(
            lambda: engine.search(
                name, np.asarray(qv, np.float32), k=int(b.get("k", 10)),
                ef=b.get("ef_search") or None,
                filter=b.get("filter") or None,
                text_query=b.get("text_query") or None,
                alpha=float(b.get("alpha", 0.5)),
                graph_root=gf.get("root_id"),
                graph_depth=int(gf.get("depth", 2)),
                graph_relation=gf.get("relation"),
                include_metadata=bool(b.get("hydrate")
                                      or b.get("hydrate_relations"))))
        res = hits[0]
        if b.get("hydrate_relations") or b.get("include_relations"):
            rels = set(b.get("include_relations") or [])
            for h in res:
                edges = engine.get_edges(name, h["id"])
                h["edges"] = [e for e in edges
                              if not rels or e["relation"] in rels]
        return _json({"results": hits_to_results(res),
                      "ids": [h["id"] for h in res]})

    async def vector_search_scores(request):
        b = await body_of(request)
        hits = await asyncio.to_thread(
            lambda: engine.search(b["index_name"],
                                  np.asarray(b["query_vector"], np.float32),
                                  k=int(b.get("k", 10))))
        return _json([{"id": h["id"], "score": h["score"],
                       "distance": h.get("distance")} for h in hits[0]])

    async def vector_delete(request):
        b = await body_of(request)
        ok = await asyncio.to_thread(engine.delete, b["index_name"], b["id"])
        if not ok:
            return _err("id not found", 404)
        return _json({"status": "ok"})

    async def vector_get(request):
        name = request.match_info["name"]
        vid = request.match_info["id"]
        h = engine._handle(name)
        vec = h.index.get_vector(vid) if hasattr(h.index, "get_vector") \
            else None
        if vec is None:
            return _err("id not found", 404)
        row = h.index.ids.get(vid)
        return _json({"id": vid, "vector": vec.tolist(),
                      "metadata": h.meta.get(row) or {}})

    async def vectors_get_batch(request):
        b = await body_of(request)
        h = engine._handle(b["index_name"])
        out = []
        for vid in b.get("ids") or []:
            row = h.index.ids.get(vid)
            if row is None:
                continue
            meta = h.meta.get(row) or {}
            # wire parity with the reference's VectorData (core.go:60-64):
            # every item carries id + vector + metadata — migration and
            # context-assembly clients rely on the vector being present
            vec = h.index.get_vector(vid) \
                if hasattr(h.index, "get_vector") else None
            item = {"id": vid,
                    "vector": vec.tolist() if vec is not None else None,
                    "metadata": meta}
            if b.get("compress_context"):
                from ..text.compressor import compress
                item["metadata"] = {
                    k: compress(v) if isinstance(v, str) else v
                    for k, v in meta.items()}
            out.append(item)
        return _json(out)

    async def vector_reinforce(request):
        b = await body_of(request)
        ids = b.get("ids") or ([b["id"]] if b.get("id") else [])
        done = 0
        for vid in ids:
            try:
                await asyncio.to_thread(engine.reinforce,
                                        b["index_name"], vid)
                done += 1
            except KeyError:
                pass
        return _json({"status": "ok", "reinforced": done})

    async def vector_compress(request):
        b = await body_of(request)
        name, precision = b["index_name"], b["precision"]

        def run():
            return engine_compress(engine, name, precision)

        t = tasks.submit("compress", run)
        return _json({"status": "started", "task_id": t.id}, 202)

    async def belief_assessment(request):
        b = await body_of(request)
        bs = await asyncio.to_thread(
            engine.belief_state, b["index_name"],
            b.get("id") or b.get("node_id"))
        from dataclasses import asdict
        return _json(asdict(bs))

    async def vector_evolve(request):
        b = await body_of(request)
        name, old_id = b["index_name"], b["old_id"]
        h = engine._handle(name)
        row = h.index.ids.get(old_id)
        if row is None:
            return _err("id not found", 404)
        old_meta = dict(h.meta.get(row) or {})
        new_meta = {k: v for k, v in old_meta.items()
                    if not k.startswith("_")}
        new_meta.update(b.get("new_metadata") or {})
        if b.get("new_content"):
            new_meta["content"] = b["new_content"]
        if b.get("reason"):
            new_meta["_evolution_reason"] = b["reason"]
        new_id = b.get("new_id") or f"{old_id}.v{uuid.uuid4().hex[:8]}"
        await asyncio.to_thread(engine.evolve, name, old_id, new_id,
                                np.asarray(b["new_vector"], np.float32),
                                new_meta)
        return _json({"status": "evolved", "new_id": new_id,
                      "old_id": old_id})

    async def vector_evolution(request):
        b = await body_of(request)
        chain = engine.evolution_chain(b["index_name"],
                                       b.get("id") or b.get("node_id"))
        return _json({"chain": chain})

    # --------------------------------------------------------------- graph

    async def graph_link(request):
        b = await body_of(request)
        if b["source_id"] == b["target_id"]:
            return _err("self-links are not allowed", 400)
        await asyncio.to_thread(
            engine.link, b["index_name"], b["source_id"],
            b["relation_type"], b["target_id"],
            weight=float(b.get("weight") or 1.0),
            props=b.get("props"),
            inverse=b.get("inverse_relation_type") or None)
        return _json({"status": "ok"})

    async def graph_unlink(request):
        b = await body_of(request)
        ok = await asyncio.to_thread(
            engine.unlink, b["index_name"], b["source_id"],
            b["relation_type"], b["target_id"])
        if b.get("inverse_relation_type"):
            await asyncio.to_thread(
                engine.unlink, b["index_name"], b["target_id"],
                b["inverse_relation_type"], b["source_id"])
        return _json({"status": "ok", "removed": ok})

    async def graph_get_links(request):
        b = await body_of(request)
        edges = engine.get_edges(b["index_name"],
                                 b.get("source_id") or b.get("node_id"),
                                 relation=b.get("relation_type"),
                                 at_time=b.get("at_time"))
        return _json({"links": [e["target"] for e in edges],
                      "edges": edges})

    async def graph_get_edges(request):
        b = await body_of(request)
        edges = engine.get_edges(b["index_name"],
                                 b.get("node_id") or b.get("source_id"),
                                 relation=b.get("relation_type"),
                                 at_time=b.get("at_time"))
        return _json({"edges": edges})

    async def graph_get_incoming(request):
        b = await body_of(request)
        edges = engine.get_incoming_edges(
            b["index_name"], b.get("target_id") or b.get("node_id"),
            relation=b.get("relation_type"), at_time=b.get("at_time"))
        return _json({"incoming": edges})

    async def graph_all_relations(request):
        b = await body_of(request)
        node = b.get("node_id")
        if node:
            # wire parity with VGetRelations (http_handlers.go:1338-1360):
            # relations is a {relation_type: [targets]} map, not a name
            # list — migration and context-assembly clients walk it
            edges = engine.get_edges(b["index_name"], node)
            rel: dict[str, list] = {}
            for e in edges:
                rel.setdefault(e["relation"], []).append(e["target"])
            return _json({"node_id": node, "relations": rel})
        return _json({"relations": engine.graph.relations()})

    async def graph_all_incoming(request):
        b = await body_of(request)
        edges = engine.get_incoming_edges(b["index_name"], b["node_id"])
        return _json({"incoming": edges})

    async def graph_connections(request):
        b = await body_of(request)
        node = b.get("node_id") or b.get("source_id")
        return _json({
            "outgoing": engine.get_edges(b["index_name"], node,
                                         at_time=b.get("at_time")),
            "incoming": engine.get_incoming_edges(
                b["index_name"], node, at_time=b.get("at_time"))})

    async def graph_traverse(request):
        b = await body_of(request)
        out = await asyncio.to_thread(
            engine.traverse, b["index_name"],
            b.get("start_id") or b.get("source_id"),
            b.get("path") or ".".join(b.get("relations") or []),
            include_metadata=bool(b.get("hydrate", True)))
        return _json({"results": out})

    async def graph_extract_subgraph(request):
        b = await body_of(request)
        rels = b.get("relations") or []
        sub = await asyncio.to_thread(
            lambda: engine.extract_subgraph(
                b["index_name"], b["root_id"],
                depth=int(b.get("max_depth", 2)),
                relation=rels[0] if len(rels) == 1 else None,
                guide_vector=b.get("guide_vector"),
                guide_threshold=float(b.get("guide_threshold", 0.0))))
        if len(rels) > 1:
            sub["edges"] = [e for e in sub["edges"]
                            if e["relation"] in set(rels)]
        return _json(sub)

    async def graph_find_path(request):
        b = await body_of(request)
        rels = b.get("relations") or []
        path = await asyncio.to_thread(
            engine.find_path, b["index_name"], b["source_id"],
            b["target_id"],
            relation=rels[0] if len(rels) == 1 else None)
        return _json({"path": path or [], "found": path is not None})

    async def graph_set_props(request):
        b = await body_of(request)
        await asyncio.to_thread(engine.update_metadata, b["index_name"],
                                b["node_id"], b.get("properties") or {})
        return _json({"status": "ok"})

    async def graph_get_props(request):
        b = await body_of(request)
        info = engine.get(b["index_name"], b["node_id"])
        return _json({"node_id": b["node_id"],
                      "properties": info["metadata"]})

    async def graph_search_nodes(request):
        b = await body_of(request)
        h = engine._handle(b["index_name"])
        if hasattr(h.index, "flush"):
            h.index.flush()
        limit = int(b.get("limit", 100))
        rows = sorted(engine._live_rows(h))
        flt = b.get("property_filter") or b.get("filter")
        if flt:
            from ..engine import filters as filtlib
            rows = sorted(filtlib.evaluate(flt, h.meta, set(rows)))
        out = []
        for r in rows[:limit]:
            ext = h.index.ids.row_to_ext[r]
            if ext is None:
                continue
            out.append({"id": ext, "metadata": h.meta.get(r) or {}})
        return _json({"nodes": out, "total": len(rows)})

    async def graph_invalidate(request):
        """Epistemic invalidation: a contradicts-edge plus metadata mark."""
        b = await body_of(request)
        await asyncio.to_thread(
            engine.link, b["index_name"], b["source_id"], "invalidates",
            b["target_id"], props={"reason": b.get("reason", "")})
        try:
            await asyncio.to_thread(
                engine.update_metadata, b["index_name"], b["target_id"],
                {"_invalidated_by": b["source_id"]})
        except KeyError:
            pass
        return _json({"status": "ok"})

    # ------------------------------------------------------ cognitive/session

    async def reflections_get(request):
        name = request.match_info["name"]
        if gardener is None:
            return _json({"reflections": []})
        return _json({"reflections": gardener.reflections(name)})

    async def reflection_resolve(request):
        if gardener is None:
            return _err("gardener disabled", 404)
        ok = gardener.resolve(request.match_info["name"],
                              request.match_info["id"])
        if not ok:
            return _err("no such reflection", 404)
        return _json({"status": "resolved"})

    async def cognitive_think(request):
        name = request.match_info["name"]
        if gardener is None:
            return _json({"status": "accepted", "note": "gardener disabled"},
                         202)
        t = tasks.submit(f"think:{name}", lambda: gardener.think(name))
        return _json({"status": "accepted", "task_id": t.id}, 202)

    async def reflection_apply(request):
        """Execute a reflection's proposed action (consolidation merge)."""
        if gardener is None:
            return _err("gardener disabled", 404)
        name, rid = request.match_info["name"], request.match_info["id"]
        try:
            out = await asyncio.to_thread(gardener.apply_reflection,
                                          name, rid)
        except KeyError as e:
            return _err(str(e).strip("'"), 404)
        return _json(out)

    async def session_summarize(request):
        """Roll a session's memories into one pinned summary node
        (gardener.go:1563)."""
        if gardener is None:
            return _err("gardener disabled", 404)
        b = await body_of(request)
        name = b.get("index_name") or "mcp_memory"
        sid = b.get("session_id") or request.match_info.get("sid")
        if not sid:
            return _err("session_id required", 400)
        out = await asyncio.to_thread(gardener.summarize_session, name, sid)
        if out is None:
            return _err("no memories for session", 404)
        return _json(out)

    async def beliefs_resolve(request):
        """Adjudicate contested beliefs (gardener.go:3277-3599)."""
        if gardener is None:
            return _err("gardener disabled", 404)
        name = request.match_info["name"]
        out = await asyncio.to_thread(gardener.resolve_volatile_beliefs,
                                      name)
        return _json({"resolved": out})

    async def session_start(request):
        b = await body_of(request) if request.can_read_body else {}
        sid = uuid.uuid4().hex
        sessions[sid] = {"id": sid, "user_id": (b or {}).get("user_id"),
                         "started": time.time(), "events": []}
        return _json({"session_id": sid})

    async def session_end(request):
        sid = request.match_info["id"]
        s = sessions.pop(sid, None)
        if s is None:
            return _err("no such session", 404)
        s["ended"] = time.time()
        return _json({"status": "ended", "session": s})

    async def transfer_memory(request):
        b = await body_of(request)
        src = engine._handle(b["source_index"])
        dst_name = b["target_index"]
        if dst_name not in engine.indexes:
            info = engine.index_info(b["source_index"])
            await asyncio.to_thread(
                engine.create_index, dst_name, metric=info["metric"],
                precision=info["precision"])
        if hasattr(src.index, "flush"):
            src.index.flush()
        rows = sorted(engine._live_rows(src))
        flt = b.get("filter")
        if flt:
            from ..engine import filters as filtlib
            rows = sorted(filtlib.evaluate(flt, src.meta, set(rows)))
        ids, vecs, metas = [], [], []
        for r in rows:
            ext = src.index.ids.row_to_ext[r]
            if ext is None or ext in engine.indexes[dst_name].index.ids:
                continue
            v = src.index.get_vector(ext)
            if v is None:
                continue
            ids.append(ext)
            vecs.append(v)
            metas.append(src.meta.get(r) or {})
        if ids:
            await asyncio.to_thread(engine.add_batch, dst_name, ids,
                                    np.stack(vecs), metas)
        return _json({"status": "ok", "transferred": len(ids)})

    async def user_profile(request):
        uid = request.match_info["id"]
        raw = engine.kv_get(f"profile:{uid}")
        if raw is None:
            return _err("no such profile", 404)
        return _json(json.loads(raw))

    async def users_list(request):
        out = []
        for k, v in engine.kv_scan("profile:"):
            try:
                out.append(json.loads(v))
            except ValueError:
                pass
        return _json({"profiles": out})

    # ----------------------------------------------------------------- RAG

    async def rag_retrieve(request):
        if rag is None:
            return _err("rag service not configured", 501)
        b = await body_of(request)
        out = await asyncio.to_thread(
            rag.retrieve, b.get("pipeline_name"), b["query"],
            int(b.get("k", 10)),
            include_provenance=bool(b.get("include_provenance")),
            compress=bool(b.get("compress_context")))
        return _json(out)

    async def rag_retrieve_adaptive(request):
        if rag is None:
            return _err("rag service not configured", 501)
        b = await body_of(request)
        out = await asyncio.to_thread(
            rag.retrieve_adaptive, b.get("pipeline_name"), b["query"],
            token_budget=int(b.get("token_budget", 2000)),
            strategy=b.get("strategy", "score_decay"))
        return _json(out)

    # -------------------------------------------------------------- auth

    async def auth_create_key(request):
        if auth_svc is None:
            return _err("auth disabled", 400)
        b = await body_of(request)
        info = auth_svc.generate_token(
            b.get("role", "read"), b.get("namespaces"),
            ttl=b.get("ttl"), name=b.get("name", ""))
        auth_svc.record_key(info)
        return _json(info)

    async def auth_list_keys(request):
        if auth_svc is None:
            return _err("auth disabled", 400)
        return _json({"keys": auth_svc.list_keys()})

    async def auth_revoke_key(request):
        if auth_svc is None:
            return _err("auth disabled", 400)
        auth_svc.revoke(request.match_info["id"])
        return _json({"status": "revoked"})

    async def jwks(request):
        if auth_svc is None:
            return _err("auth disabled", 400)
        return _json(auth_svc.jwks())

    # ------------------------------------------------------------ compiler

    async def compile_artifact(request):
        if compiler is None:
            return _err("compiler not configured", 501)
        b = await body_of(request)
        out = await asyncio.to_thread(compiler.compile, b)
        return _json(out)

    async def compile_templates(request):
        if compiler is None:
            return _json({"templates": []})
        return _json({"templates": compiler.templates()})

    async def artifacts_list(request):
        if compiler is None:
            return _json({"artifacts": []})
        return _json({"artifacts": compiler.list_artifacts(
            request.query.get("index"))})

    async def artifact_get(request):
        if compiler is None:
            return _err("compiler not configured", 501)
        art = compiler.get_artifact(
            request.match_info["template"],
            index=request.query.get("index"),
            entity_type=request.query.get("entity_type"),
            entity_id=request.query.get("entity_id"))
        if art is None:
            return _err("artifact not found", 404)
        return _json(art)

    # --------------------------------------------------------------- routes

    r = app.router
    r.add_get("/healthz", healthz)
    r.add_post("/system/save", system_save)
    r.add_post("/system/aof-rewrite", system_aof_rewrite)
    r.add_get("/system/stats", system_stats)
    r.add_get("/system/tasks/{id}", system_task)
    r.add_get("/system/gardener", system_gardener)
    r.add_get("/system/embedder/status", embedder_status)
    r.add_post("/system/embedder/reload", embedder_reload)
    r.add_get("/system/vectorizers", vectorizers_list)
    r.add_post("/system/vectorizers/{name}/trigger", vectorizers_trigger)
    r.add_get("/metrics", metrics_route)
    r.add_get("/events/stream", events_stream)

    r.add_get("/kv/{key}", kv_get)
    r.add_post("/kv/{key}", kv_set)
    r.add_put("/kv/{key}", kv_set)
    r.add_delete("/kv/{key}", kv_delete)

    r.add_get("/vector/indexes", indexes_list)
    r.add_post("/vector/indexes", index_create)
    r.add_post("/vector/actions/create", index_create)
    r.add_post("/vector/actions/add", vector_add)
    r.add_post("/vector/actions/add-batch", vector_add_batch)
    r.add_post("/vector/actions/import", vector_import)
    r.add_post("/vector/actions/import/commit", vector_import_commit)
    r.add_post("/vector/actions/search", vector_search)
    r.add_post("/vector/actions/search-with-scores", vector_search_scores)
    r.add_post("/vector/actions/delete_vector", vector_delete)
    r.add_post("/vector/actions/compress", vector_compress)
    r.add_post("/vector/actions/get-vectors", vectors_get_batch)
    r.add_post("/vector/actions/reinforce", vector_reinforce)
    r.add_post("/vector/actions/belief-assessment", belief_assessment)
    r.add_post("/vector/actions/evolve", vector_evolve)
    r.add_post("/vector/actions/get-evolution", vector_evolution)

    r.add_post("/graph/actions/link", graph_link)
    r.add_post("/graph/actions/unlink", graph_unlink)
    r.add_post("/graph/actions/get-links", graph_get_links)
    r.add_post("/graph/actions/get-connections", graph_connections)
    r.add_post("/graph/actions/traverse", graph_traverse)
    r.add_post("/graph/actions/get-incoming", graph_get_incoming)
    r.add_post("/graph/actions/extract-subgraph", graph_extract_subgraph)
    r.add_post("/graph/actions/set-node-properties", graph_set_props)
    r.add_post("/graph/actions/get-node-properties", graph_get_props)
    r.add_post("/graph/actions/search-nodes", graph_search_nodes)
    r.add_post("/graph/actions/get-edges", graph_get_edges)
    r.add_post("/graph/actions/find-path", graph_find_path)
    r.add_post("/graph/actions/get-all-relations", graph_all_relations)
    r.add_post("/graph/actions/get-all-incoming", graph_all_incoming)
    r.add_post("/graph/actions/invalidate", graph_invalidate)

    r.add_get("/vector/indexes/{name}/reflections", reflections_get)
    r.add_post("/vector/indexes/{name}/reflections/{id}/resolve",
               reflection_resolve)
    r.add_post("/vector/indexes/{name}/reflections/{id}/apply",
               reflection_apply)
    r.add_post("/vector/indexes/{name}/cognitive/think", cognitive_think)
    r.add_post("/vector/indexes/{name}/cognitive/resolve-beliefs",
               beliefs_resolve)
    r.add_post("/cognitive/summarize-session", session_summarize)
    r.add_post("/sessions", session_start)
    r.add_post("/sessions/{id}/end", session_end)
    r.add_post("/transfer/memory", transfer_memory)
    r.add_post("/rag/retrieve", rag_retrieve)
    r.add_post("/rag/retrieve-adaptive", rag_retrieve_adaptive)

    r.add_get("/vector/indexes/{name}", index_get)
    r.add_delete("/vector/indexes/{name}", index_delete)
    r.add_post("/vector/indexes/{name}/config", index_config)
    r.add_post("/vector/indexes/{name}/maintenance", index_maintenance)
    r.add_put("/vector/indexes/{name}/auto-links", auto_links_put)
    r.add_get("/vector/indexes/{name}/auto-links", auto_links_get)
    r.add_get("/vector/indexes/{name}/export", index_export)
    r.add_get("/vector/indexes/{name}/vectors/{id}", vector_get)

    r.add_post("/auth/keys", auth_create_key)
    r.add_get("/auth/keys", auth_list_keys)
    r.add_delete("/auth/keys/{id}", auth_revoke_key)
    r.add_get("/.well-known/jwks.json", jwks)

    r.add_post("/compile", compile_artifact)
    r.add_get("/compile/templates", compile_templates)
    r.add_get("/artifacts", artifacts_list)
    r.add_get("/artifact/{template}", artifact_get)

    # -- web UI (reference embeds a vanilla-JS dashboard, ui/fs.go) ---------
    ui_dir = os.path.join(os.path.dirname(__file__), "ui")

    async def ui_index(request):
        return web.FileResponse(os.path.join(ui_dir, "index.html"))

    async def ui_explore(request):
        """POST /ui/explore — search helper for the dashboard."""
        b = await body_of(request)
        return await vector_search(request)

    async def ui_docs(request):
        return web.FileResponse(os.path.join(ui_dir, "docs.html"))

    r.add_get("/ui", ui_index)
    r.add_get("/ui/", ui_index)
    r.add_get("/ui/docs", ui_docs)
    r.add_post("/ui/explore", ui_explore)
    if os.path.isdir(ui_dir):
        r.add_static("/ui/static", ui_dir)

    # -- profiling (reference exposes pprof; here: torch.profiler traces) ---
    async def debug_profile(request):
        seconds = float(request.query.get("seconds", 3))
        import tempfile

        import torch
        tmp = tempfile.mkdtemp(prefix="kektor-trace-")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)

        def run():
            # started and stopped in this task's thread; the card's
            # activity is traced process-wide
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            time.sleep(min(seconds, 30))
            prof.stop()
            prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
            return {"trace_dir": tmp}

        t = tasks.submit("profile", run)
        return _json({"status": "started", "task_id": t.id,
                      "trace_dir": tmp}, 202)

    r.add_post("/debug/profile", debug_profile)

    # -- OpenAPI (reference embeds swagger in the web UI) --------------------
    async def openapi(request):
        paths: dict[str, dict] = {}
        for route in app.router.routes():
            info = route.resource.get_info() if route.resource else {}
            path = info.get("path") or info.get("formatter")
            if not path or path.startswith("/ui/static"):
                continue
            method = route.method.lower()
            if method in ("head", "options", "*"):
                continue
            doc = (route.handler.__doc__ or "").strip().split("\n")[0]
            paths.setdefault(path, {})[method] = {
                "summary": doc or route.handler.__name__,
                "responses": {"200": {"description": "OK"}},
            }
        return _json({
            "openapi": "3.0.0",
            "info": {"title": "KektorDB-TPU", "version": "0.1.0"},
            "paths": paths,
        })

    r.add_get("/openapi.json", openapi)

    return app


def engine_compress(engine: Engine, name: str, precision: str) -> dict:
    """Rebuild an index at a new precision (Compress, core.go:1095)."""
    h = engine._handle(name)
    idx = h.index
    if hasattr(idx, "flush"):
        idx.flush()
    info = engine.index_info(name)
    ids, vecs, metas = [], [], []
    for ext, row in sorted(idx.ids.ext_to_row.items()):
        v = idx.get_vector(ext)
        if v is None:
            continue
        ids.append(ext)
        vecs.append(v)
        metas.append(h.meta.get(row) or {})
    # preserve the index topology: a sharded/scan-mode/flat index must come
    # back with the same kind/shards/serve_mode, not a default HNSW
    from ..index.bruteforce import BruteForceIndex
    from ..index.hostarena import HostArenaIndex
    from ..parallel.sharded import ShardedHNSW
    kind = "flat" if isinstance(idx, BruteForceIndex) \
        else "host" if isinstance(idx, HostArenaIndex) else "hnsw"
    shards = idx.n_shards if isinstance(idx, ShardedHNSW) else 0
    serve_mode = getattr(getattr(idx, "config", None), "serve_mode", "auto")
    # proj knobs live on config for hnsw/sharded, as attributes for host;
    # an auto host mirror must survive migration as auto (None), not be
    # frozen at whatever it had resolved to (0 before the first trigger)
    if getattr(idx, "_proj_auto", False):
        proj_dim = None
    else:
        proj_dim = info["config"].get(
            "serve_proj_dim", getattr(idx, "proj_dim", 0))
    proj_rerank = info["config"].get(
        "serve_proj_rerank", getattr(idx, "proj_rerank", 128))
    engine.drop_index(name)
    engine.create_index(name, metric=info["metric"], precision=precision,
                        m=info["config"].get("m", 16),
                        ef_construction=info["config"].get(
                            "ef_construction", 200),
                        ef_search=info["config"].get("ef_search", 100),
                        kind=kind, shards=shards, serve_mode=serve_mode,
                        serve_proj_dim=proj_dim,
                        serve_proj_rerank=proj_rerank)
    if ids:
        engine.add_batch(name, ids, np.stack(vecs), metas)
    return {"status": "ok", "precision": precision, "count": len(ids)}


def run_server(engine: Engine, host: str = "0.0.0.0", port: int = 9091,
               **kw) -> None:
    app = make_app(engine, **kw)
    web.run_app(app, host=host, port=port, print=None)
