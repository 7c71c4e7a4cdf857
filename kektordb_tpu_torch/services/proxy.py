"""AI Gateway — OpenAI-compatible reverse proxy with semantic firewall,
semantic cache, and zero-code RAG injection.

Reference: pkg/proxy (proxy.go:48,100-323):
  ① semantic firewall — block when max similarity to the `prompt_guard`
    index exceeds threshold, plus a literal deny list (firewall.go)
  ② semantic cache — vector lookup of past answers with TTL + vacuum +
    invalidation (proxy.go:408-465,754)
  ③ RAG injection — CQR query rewriting via a fast LLM (:342), grounded
    HyDE via a smart LLM (:359), standard or adaptive retrieval (:503-727)
  streaming passthrough detection (:385); config proxy.yaml
  (config.go:10-66).

The gateway runs as an aiohttp app mountable next to the main server.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

log = logging.getLogger("kektordb.proxy")

GUARD_INDEX = "prompt_guard"
CACHE_INDEX = "semantic_cache"


@dataclass
class ProxyConfig:
    """proxy.yaml (pkg/proxy/config.go:10-66)."""
    upstream_url: str = "http://localhost:8000/v1"
    upstream_key: str = ""
    firewall_enabled: bool = False
    firewall_threshold: float = 0.85       # similarity to a guard prompt
    deny_list: list[str] = field(default_factory=list)
    cache_enabled: bool = True
    cache_threshold: float = 0.95
    cache_ttl: float = 3600.0
    rag_enabled: bool = False
    rag_index: str = ""
    rag_k: int = 5
    rag_adaptive: bool = False
    rag_token_budget: int = 2000
    cqr_enabled: bool = False              # query rewriting (fast LLM)
    hyde_enabled: bool = False             # grounded HyDE (smart LLM)
    asset_base_url: str = ""               # rewrite kektor-asset:// URLs

    @classmethod
    def from_yaml(cls, path: str) -> "ProxyConfig":
        """Load proxy.yaml (pkg/proxy/config_loader.go:103). Unknown keys
        are ignored; KEKTOR_PROXY_* env vars override file values."""
        import os

        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        # accept both flat keys and the reference's nested sections
        flat: dict[str, Any] = {}
        for k, v in raw.items():
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    flat[f"{k}_{k2}"] = v2
                    flat[k2] = v2
            else:
                flat[k] = v
        known = {f.name for f in cls.__dataclass_fields__.values()}
        kw = {k: v for k, v in flat.items() if k in known}
        cfg = cls(**kw)
        for f in cls.__dataclass_fields__.values():
            env = os.environ.get(f"KEKTOR_PROXY_{f.name.upper()}")
            if env is not None:
                cur = getattr(cfg, f.name)
                if isinstance(cur, bool):
                    setattr(cfg, f.name, env.lower() in ("1", "true", "yes"))
                elif isinstance(cur, float):
                    setattr(cfg, f.name, float(env))
                elif isinstance(cur, int):
                    setattr(cfg, f.name, int(env))
                elif isinstance(cur, list):
                    setattr(cfg, f.name, [s for s in env.split(",") if s])
                else:
                    setattr(cfg, f.name, env)
        return cfg


class AIGateway:
    def __init__(self, engine, embedder, config: Optional[ProxyConfig] = None,
                 fast_llm=None, smart_llm=None):
        self.engine = engine
        self.embedder = embedder
        self.config = config or ProxyConfig()
        self.fast_llm = fast_llm
        self.smart_llm = smart_llm
        self.stats = {"requests": 0, "cache_hits": 0, "blocked": 0,
                      "rag_injections": 0}

    # ------------------------------------------------------------ firewall

    def add_guard_prompt(self, text: str) -> str:
        if GUARD_INDEX not in self.engine.indexes:
            self.engine.create_index(GUARD_INDEX, metric="cosine")
        gid = f"guard_{uuid.uuid4().hex[:10]}"
        self.engine.add(GUARD_INDEX, gid, self.embedder.embed(text),
                        {"content": text, "_pinned": True})
        return gid

    def check_firewall(self, prompt: str) -> Optional[str]:
        """Returns a block reason, or None if allowed (firewall.go)."""
        if not self.config.firewall_enabled:
            return None
        low = prompt.lower()
        for term in self.config.deny_list:
            if term.lower() in low:
                return f"denied term: {term}"
        if GUARD_INDEX in self.engine.indexes and \
                len(self.engine.indexes[GUARD_INDEX].index) > 0:
            hits = self.engine.search(GUARD_INDEX,
                                      self.embedder.embed(prompt), k=1)[0]
            if hits and hits[0].get("distance") is not None:
                sim = 1.0 - hits[0]["distance"]   # cosine distance → sim
                if sim >= self.config.firewall_threshold:
                    return f"semantic match to guard prompt " \
                           f"{hits[0]['id']} (sim={sim:.2f})"
        return None

    # --------------------------------------------------------------- cache

    def _ensure_cache(self) -> None:
        if CACHE_INDEX not in self.engine.indexes:
            self.engine.create_index(CACHE_INDEX, metric="cosine")

    def cache_lookup(self, prompt: str) -> Optional[str]:
        if not self.config.cache_enabled:
            return None
        self._ensure_cache()
        if len(self.engine.indexes[CACHE_INDEX].index) == 0:
            return None
        hits = self.engine.search(CACHE_INDEX, self.embedder.embed(prompt),
                                  k=1, include_metadata=True)[0]
        if not hits or hits[0].get("distance") is None:
            return None
        sim = 1.0 - hits[0]["distance"]
        meta = hits[0].get("metadata") or {}
        if sim < self.config.cache_threshold:
            return None
        if time.time() - float(meta.get("cached_at", 0)) \
                > self.config.cache_ttl:
            return None
        return meta.get("answer")

    def cache_store(self, prompt: str, answer: str) -> None:
        if not self.config.cache_enabled:
            return
        self._ensure_cache()
        cid = f"cache_{uuid.uuid4().hex[:10]}"
        self.engine.add(CACHE_INDEX, cid, self.embedder.embed(prompt),
                        {"prompt": prompt[:500], "answer": answer,
                         "cached_at": time.time()})

    def cache_vacuum(self) -> int:
        """Drop expired entries (proxy.go:754)."""
        if CACHE_INDEX not in self.engine.indexes:
            return 0
        h = self.engine._handle(CACHE_INDEX)
        cutoff = time.time() - self.config.cache_ttl
        stale = []
        for row, meta in list(h.meta.direct.items()):
            if float(meta.get("cached_at", 0)) < cutoff:
                ext = h.index.ids.row_to_ext[row] \
                    if row < len(h.index.ids.row_to_ext) else None
                if ext:
                    stale.append(ext)
        for ext in stale:
            self.engine.delete(CACHE_INDEX, ext)
        return len(stale)

    def cache_invalidate(self) -> None:
        if CACHE_INDEX in self.engine.indexes:
            self.engine.drop_index(CACHE_INDEX)

    # ----------------------------------------------------- RAG injection

    def _rewrite_query(self, prompt: str, history: list[dict]) -> str:
        """CQR via fast LLM (proxy.go:342); passthrough without one."""
        if not self.config.cqr_enabled or self.fast_llm is None:
            return prompt
        try:
            ctx = "\n".join(f"{m['role']}: {m['content'][:200]}"
                            for m in history[-4:])
            return self.fast_llm.chat(
                "Rewrite the final user question as a standalone search "
                "query. Reply with only the query.",
                f"{ctx}\nquestion: {prompt}").strip() or prompt
        except Exception:
            return prompt

    def _hyde(self, query: str) -> Optional[str]:
        """Grounded HyDE via smart LLM (proxy.go:359)."""
        if not self.config.hyde_enabled or self.smart_llm is None:
            return None
        try:
            return self.smart_llm.chat(
                "Write a short hypothetical passage that would answer the "
                "query. Facts only, 3 sentences.", query)
        except Exception:
            return None

    def build_rag_context(self, prompt: str,
                          history: list[dict]) -> Optional[str]:
        cfg = self.config
        if not cfg.rag_enabled or not cfg.rag_index or \
                cfg.rag_index not in self.engine.indexes:
            return None
        query = self._rewrite_query(prompt, history)
        hyde = self._hyde(query)
        search_text = hyde or query
        if cfg.rag_adaptive:
            from .rag import AdaptiveRetriever
            out = AdaptiveRetriever(self.engine, self.embedder).retrieve(
                cfg.rag_index, search_text,
                token_budget=cfg.rag_token_budget)
            return out["context_text"] or None
        hits = self.engine.search(cfg.rag_index,
                                  self.embedder.embed(search_text),
                                  k=cfg.rag_k, text_query=query,
                                  include_metadata=True)[0]
        chunks = [(h.get("metadata") or {}).get("content", "")
                  for h in hits]
        text = "\n\n".join(c for c in chunks if c)
        if text and cfg.asset_base_url:
            # asset URL rewriting (proxy.go:503-727): internal asset refs
            # become fetchable URLs for the upstream model
            text = text.replace("kektor-asset://",
                                cfg.asset_base_url.rstrip("/") + "/")
        return text or None

    # ------------------------------------------------------- request path

    def process_chat(self, body: dict) -> tuple[Optional[dict], dict]:
        """Pre-process one /chat/completions request.

        Returns (immediate_response, possibly-rewritten body). An immediate
        response is a firewall block or a cache hit (zero upstream tokens).
        """
        self.stats["requests"] += 1
        messages = body.get("messages") or []
        user_msgs = [m for m in messages if m.get("role") == "user"]
        prompt = user_msgs[-1]["content"] if user_msgs else ""
        if isinstance(prompt, list):           # multimodal content array
            prompt = " ".join(p.get("text", "") for p in prompt
                              if isinstance(p, dict))

        reason = self.check_firewall(prompt)
        if reason is not None:
            self.stats["blocked"] += 1
            return ({"error": {"message": f"blocked by semantic firewall: "
                                          f"{reason}",
                               "type": "firewall_block", "code": 403}},
                    body)

        if not body.get("stream"):
            cached = self.cache_lookup(prompt)
            if cached is not None:
                self.stats["cache_hits"] += 1
                return ({"id": f"cache-{uuid.uuid4().hex[:12]}",
                         "object": "chat.completion",
                         "model": body.get("model", "cached"),
                         "choices": [{"index": 0, "finish_reason": "stop",
                                      "message": {"role": "assistant",
                                                  "content": cached}}],
                         "usage": {"prompt_tokens": 0,
                                   "completion_tokens": 0,
                                   "total_tokens": 0},
                         "kektordb_cache": "hit"}, body)

        ctx = self.build_rag_context(prompt, messages)
        if ctx:
            self.stats["rag_injections"] += 1
            inject = {"role": "system",
                      "content": "Relevant context from the knowledge "
                                 f"base:\n{ctx}"}
            body = dict(body)
            body["messages"] = [inject] + messages
        return None, body

    def record_response(self, body: dict, response: dict) -> None:
        """Store the upstream answer in the semantic cache."""
        try:
            messages = body.get("messages") or []
            user_msgs = [m for m in messages if m.get("role") == "user"]
            prompt = user_msgs[-1]["content"] if user_msgs else ""
            answer = response["choices"][0]["message"]["content"]
            if isinstance(prompt, str) and answer:
                self.cache_store(prompt, answer)
        except (KeyError, IndexError, TypeError):
            pass


def make_gateway_app(gateway: AIGateway):
    """aiohttp app: POST /v1/chat/completions proxied through the gateway
    (streaming requests pass through untouched, proxy.go:385)."""
    import aiohttp
    from aiohttp import web

    async def chat(request):
        body = await request.json()
        immediate, body = gateway.process_chat(body)
        if immediate is not None:
            status = 403 if "error" in immediate else 200
            return web.json_response(immediate, status=status)
        headers = {"Content-Type": "application/json"}
        if gateway.config.upstream_key:
            headers["Authorization"] = \
                f"Bearer {gateway.config.upstream_key}"
        url = gateway.config.upstream_url.rstrip("/") + "/chat/completions"
        async with aiohttp.ClientSession() as sess:
            if body.get("stream"):
                upstream = await sess.post(url, json=body, headers=headers)
                resp = web.StreamResponse(status=upstream.status)
                resp.content_type = "text/event-stream"
                await resp.prepare(request)
                async for chunk in upstream.content.iter_any():
                    await resp.write(chunk)
                return resp
            upstream = await sess.post(url, json=body, headers=headers)
            data = await upstream.json()
            if upstream.status == 200:
                gateway.record_response(body, data)
            return web.json_response(data, status=upstream.status)

    async def passthrough(request):
        """Transparent upstream forwarding for non-chat OpenAI endpoints
        (/v1/models, /v1/embeddings, ...)."""
        headers = {}
        if gateway.config.upstream_key:
            headers["Authorization"] = \
                f"Bearer {gateway.config.upstream_key}"
        base = gateway.config.upstream_url.rstrip("/")
        suffix = request.path[len("/v1"):]
        url = base + suffix
        data = await request.read()
        if request.content_type == "application/json":
            headers["Content-Type"] = "application/json"
        async with aiohttp.ClientSession() as sess:
            upstream = await sess.request(
                request.method, url, data=data or None, headers=headers)
            body_bytes = await upstream.read()
            return web.Response(
                body=body_bytes, status=upstream.status,
                content_type=upstream.content_type)

    async def invalidate(request):
        gateway.cache_invalidate()
        return web.json_response({"status": "ok"})

    async def vacuum(request):
        return web.json_response({"removed": gateway.cache_vacuum()})

    async def stats(request):
        return web.json_response(gateway.stats)

    async def healthz(request):
        return web.json_response({"status": "ok"})

    app = web.Application()
    app.router.add_post("/v1/chat/completions", chat)
    app.router.add_get("/v1/models", passthrough)
    app.router.add_post("/v1/embeddings", passthrough)
    app.router.add_post("/v1/completions", passthrough)
    app.router.add_post("/cache/invalidate", invalidate)
    app.router.add_post("/cache/vacuum", vacuum)
    app.router.add_get("/stats", stats)
    app.router.add_get("/healthz", healthz)
    return app
