"""Cognitive client helpers: sessions, adaptive context assembly,
multi-agent coordination.

Reference: clients/python/kektordb_client/cognitive.py (CognitiveSession)
and pkg/client/cognitive/{session,adaptive,multi_agent}.go (Session,
ContextAssembler, MultiAgentCoordinator)."""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Optional, Sequence

from .client import KektorDBClient


class CognitiveSession:
    """Scoped working memory on top of the HTTP API."""

    def __init__(self, client: KektorDBClient, index: str = "mcp_memory",
                 user_id: Optional[str] = None,
                 embed: Optional[Callable[[str], Sequence[float]]] = None):
        self.client = client
        self.index = index
        self.user_id = user_id
        self._embed = embed
        self.session_id = client.start_session(user_id)
        self.saved: list[str] = []

    def _vector(self, text: str) -> Sequence[float]:
        if self._embed is None:
            from ..services.embeddings import HashingEmbedder
            self._embed = HashingEmbedder().embed
        return list(map(float, self._embed(text)))

    def remember(self, content: str,
                 metadata: Optional[dict] = None) -> str:
        mem_id = f"mem_{uuid.uuid4().hex[:12]}"
        meta = dict(metadata or {})
        meta.update({"content": content, "session_id": self.session_id,
                     "_indexed_fields": ["content"]})
        if self.user_id:
            meta["user_id"] = self.user_id
        try:
            self.client.index_info(self.index)
        except Exception:
            self.client.vcreate(self.index, metric="cosine")
        self.client.vadd(self.index, mem_id, self._vector(content), meta)
        self.saved.append(mem_id)
        return mem_id

    def recall(self, query: str, k: int = 5,
               session_only: bool = False) -> list[dict]:
        flt = f"session_id = {self.session_id}" if session_only else None
        out = self.client.vsearch(self.index, self._vector(query), k=k,
                                  filter=flt, text_query=query,
                                  hydrate=True)
        return out["results"]

    def assemble_context(self, query: str, token_budget: int = 2000) -> str:
        """ContextAssembler (pkg/client/cognitive/adaptive.go): budget-bound
        context from recalled memories."""
        hits = self.recall(query, k=20)
        parts: list[str] = []
        used = 0
        for h in hits:
            content = (h.get("metadata") or {}).get("content", "")
            t = max(len(content) // 4, 1)
            if used + t > token_budget and parts:
                break
            used += t
            parts.append(content)
        return "\n\n".join(parts)

    def end(self) -> dict:
        return self.client.end_session(self.session_id)


class MultiAgentCoordinator:
    """Shared-state multi-agent orchestration
    (pkg/client/cognitive/multi_agent.go): register agents, run pipelines
    or parallel fan-outs, share state through the KV store."""

    def __init__(self, client: KektorDBClient, namespace: str = "agents"):
        self.client = client
        self.namespace = namespace
        self.agents: dict[str, Callable[[dict], dict]] = {}

    def register(self, name: str, fn: Callable[[dict], dict]) -> None:
        self.agents[name] = fn

    def set_shared(self, key: str, value: str) -> None:
        self.client.kv_set(f"{self.namespace}:{key}", value)

    def get_shared(self, key: str) -> Optional[str]:
        try:
            return self.client.kv_get(f"{self.namespace}:{key}").decode()
        except Exception:
            return None

    def run_pipeline(self, names: Sequence[str],
                     payload: dict) -> dict:
        state: dict[str, Any] = dict(payload)
        for name in names:
            if name not in self.agents:
                raise KeyError(f"unknown agent: {name}")
            state = self.agents[name](state) or state
            state.setdefault("_trace", []).append(
                {"agent": name, "at": time.time()})
        return state

    def run_parallel(self, names: Sequence[str],
                     payload: dict) -> dict[str, dict]:
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(max_workers=len(names) or 1) as pool:
            futs = {name: pool.submit(self.agents[name], dict(payload))
                    for name in names}
            return {name: f.result() for name, f in futs.items()}
