"""MCP server — agent memory tools over JSON-RPC/stdio.

Reference: internal/mcp — 57 tools (toolnames.go; 49 agent + 8 admin,
server.go:21-66), a `Service` holding engine + embedder + session map, and a
lazily-created default index `mcp_memory` (cosine, 30-day half-life).

Protocol: MCP subset — initialize, tools/list, tools/call over stdio
JSON-RPC 2.0 (newline-delimited). Tool results are returned as
{"content": [{"type": "text", "text": <json>}]}.
"""

from __future__ import annotations

import json
import sys
import time
import uuid
from typing import Any, Callable, Optional

import numpy as np

DEFAULT_INDEX = "mcp_memory"
MEMORY_HALF_LIFE = 30 * 24 * 3600.0


class MCPService:
    """Tool implementations (internal/mcp/service.go)."""

    def __init__(self, engine, embedder=None, compiler=None, gardener=None):
        self.engine = engine
        if embedder is None:
            from ..services.embeddings import select_embedder
            embedder = select_embedder("auto")
        self.embedder = embedder
        self.compiler = compiler
        self.gardener = gardener
        self.sessions: dict[str, dict] = {}
        self._tools: dict[str, tuple[Callable, str, dict]] = {}
        self._register_all()

    # ---------------------------------------------------------- plumbing

    def ensure_index(self, name: str = DEFAULT_INDEX) -> str:
        """Lazily create the default memory index (cosine, 30-day
        half-life) — internal/mcp server behavior."""
        if name not in self.engine.indexes:
            self.engine.create_index(name, metric="cosine")
            self.engine.configure_index(name, {"memory": {
                "enabled": True, "decay_half_life": MEMORY_HALF_LIFE,
                "decay_model": "ebbinghaus"}})
        return name

    def tool(self, name: str, description: str, schema: dict):
        def deco(fn):
            self._tools[name] = (fn, description, schema)
            return fn
        return deco

    def list_tools(self) -> list[dict]:
        return [{"name": n, "description": d,
                 "inputSchema": {"type": "object", "properties": s}}
                for n, (_, d, s) in sorted(self._tools.items())]

    def call(self, name: str, args: dict[str, Any]) -> Any:
        if name not in self._tools:
            raise KeyError(f"unknown tool: {name}")
        fn, _, _ = self._tools[name]
        return fn(args or {})

    # ------------------------------------------------------- registration

    def _register_all(self) -> None:
        t = self.tool
        e = self.engine
        S = {"type": "string"}
        N = {"type": "number"}
        A = {"type": "array"}
        O = {"type": "object"}

        def idx(a):
            return self.ensure_index(a.get("index") or DEFAULT_INDEX)

        def embed(text):
            return self.embedder.embed(text)

        # ---- memory core -------------------------------------------------
        @t("save_memory", "Store a memory with content, optional metadata, "
           "session and entity links", {"content": S, "metadata": O,
                                        "session_id": S, "index": S})
        def save_memory(a):
            name = idx(a)
            mem_id = a.get("id") or f"mem_{uuid.uuid4().hex[:12]}"
            meta = dict(a.get("metadata") or {})
            meta["content"] = a["content"]
            meta.setdefault("_indexed_fields", ["content"])
            if a.get("session_id"):
                meta["session_id"] = a["session_id"]
            e.add(name, mem_id, embed(a["content"]), meta)
            if a.get("session_id") and a["session_id"] in self.sessions:
                self.sessions[a["session_id"]]["memories"].append(mem_id)
            return {"id": mem_id, "index": name}

        @t("recall_memory", "Semantic + keyword recall of stored memories",
           {"query": S, "k": N, "filter": S, "index": S})
        def recall_memory(a):
            name = idx(a)
            hits = e.search(name, embed(a["query"]),
                            k=int(a.get("k", 5)),
                            filter=a.get("filter") or None,
                            text_query=a.get("query"),
                            include_metadata=True)[0]
            for h in hits:
                try:
                    e.reinforce(name, h["id"])
                except KeyError:
                    pass
            return {"memories": [
                {"id": h["id"], "score": h["score"],
                 "content": (h.get("metadata") or {}).get("content"),
                 "metadata": h.get("metadata")} for h in hits]}

        @t("scoped_recall", "Recall restricted to a session or graph scope",
           {"query": S, "session_id": S, "root_id": S, "depth": N,
            "k": N, "index": S})
        def scoped_recall(a):
            name = idx(a)
            flt = None
            if a.get("session_id"):
                flt = f"session_id = {a['session_id']}"
            hits = e.search(name, embed(a["query"]), k=int(a.get("k", 5)),
                            filter=flt, graph_root=a.get("root_id"),
                            graph_depth=int(a.get("depth", 2)),
                            include_metadata=True)[0]
            return {"memories": [{"id": h["id"], "score": h["score"],
                                  "content": (h.get("metadata") or {})
                                  .get("content")} for h in hits]}

        @t("get_memory", "Fetch one memory by id",
           {"id": S, "index": S})
        def get_memory(a):
            return e.get(idx(a), a["id"])

        @t("get_memories", "Fetch multiple memories by id",
           {"ids": A, "index": S})
        def get_memories(a):
            name = idx(a)
            out = []
            for i in a.get("ids") or []:
                try:
                    out.append(e.get(name, i))
                except KeyError:
                    pass
            return {"memories": out}

        @t("delete_memory", "Delete a memory", {"id": S, "index": S})
        def delete_memory(a):
            return {"deleted": e.delete(idx(a), a["id"])}

        @t("reinforce_memory", "Reinforce memories (access bump)",
           {"ids": A, "index": S})
        def reinforce_memory(a):
            n = 0
            for i in a.get("ids") or []:
                try:
                    e.reinforce(idx(a), i)
                    n += 1
                except KeyError:
                    pass
            return {"reinforced": n}

        @t("unpin_memory", "Remove the pinned flag so a memory can decay",
           {"id": S, "index": S})
        def unpin_memory(a):
            e.update_metadata(idx(a), a["id"], {"_pinned": False})
            return {"status": "ok"}

        @t("evolve_memory", "Supersede a memory with an evolved version",
           {"old_id": S, "new_content": S, "metadata": O, "index": S})
        def evolve_memory(a):
            name = idx(a)
            new_id = f"mem_{uuid.uuid4().hex[:12]}"
            meta = dict(a.get("metadata") or {})
            meta["content"] = a["new_content"]
            meta.setdefault("_indexed_fields", ["content"])
            e.evolve(name, a["old_id"], new_id, embed(a["new_content"]),
                     meta)
            return {"new_id": new_id}

        @t("get_memory_evolution", "Walk a memory's evolution chain",
           {"id": S, "index": S})
        def get_memory_evolution(a):
            return {"chain": e.evolution_chain(idx(a), a["id"])}

        @t("summarize_memories", "Deterministic extractive summary of "
           "matching memories", {"query": S, "k": N, "index": S})
        def summarize_memories(a):
            hits = e.search(idx(a), embed(a.get("query", "")),
                            k=int(a.get("k", 10)),
                            text_query=a.get("query"),
                            include_metadata=True)[0]
            lines = [(h.get("metadata") or {}).get("content", "")
                     for h in hits]
            return {"summary": " • ".join(x for x in lines if x)[:2000],
                    "count": len(hits)}

        # ---- entities & graph -------------------------------------------
        @t("create_entity", "Create a graph entity node (zero vector)",
           {"name": S, "entity_type": S, "metadata": O, "index": S})
        def create_entity(a):
            name = idx(a)
            eid = a.get("id") or f"ent_{a['name'].lower().replace(' ', '_')}"
            meta = dict(a.get("metadata") or {})
            meta.update({"name": a["name"], "type": "entity",
                         "entity_type": a.get("entity_type", "concept"),
                         "entity_id": eid, "_pinned": True})
            e.add(name, eid, np.zeros(self.embedder.dim, np.float32), meta)
            return {"id": eid}

        @t("connect_entities", "Create a relation between two nodes",
           {"source": S, "relation": S, "target": S, "weight": N,
            "index": S})
        def connect_entities(a):
            e.link(idx(a), a["source"], a["relation"], a["target"],
                   weight=float(a.get("weight", 1.0)),
                   props=a.get("props"))
            return {"status": "linked"}

        @t("unlink_entities", "Remove a relation between two nodes",
           {"source": S, "relation": S, "target": S, "index": S})
        def unlink_entities(a):
            return {"removed": e.unlink(idx(a), a["source"], a["relation"],
                                        a["target"])}

        @t("explore_connections", "BFS subgraph around a node",
           {"id": S, "depth": N, "index": S})
        def explore_connections(a):
            return e.extract_subgraph(idx(a), a["id"],
                                      depth=int(a.get("depth", 2)))

        @t("find_connection", "Shortest path between two nodes",
           {"source": S, "target": S, "index": S})
        def find_connection(a):
            p = e.find_path(idx(a), a["source"], a["target"])
            return {"path": p or [], "found": p is not None}

        @t("extract_subgraph", "Extract a BFS subgraph with optional "
           "semantic guide", {"root_id": S, "depth": N, "guide": S,
                              "index": S})
        def extract_subgraph(a):
            gv = embed(a["guide"]) if a.get("guide") else None
            return e.extract_subgraph(idx(a), a["root_id"],
                                      depth=int(a.get("depth", 2)),
                                      guide_vector=gv)

        @t("find_path", "Shortest path between nodes",
           {"source": S, "target": S, "index": S})
        def find_path(a):
            p = e.find_path(idx(a), a["source"], a["target"])
            return {"path": p or [], "found": p is not None}

        @t("get_relations", "List all relation types in the graph",
           {"index": S})
        def get_relations(a):
            return {"relations": e.graph.relations()}

        @t("get_edge_details", "Full edge list for a node",
           {"id": S, "index": S})
        def get_edge_details(a):
            return {"outgoing": e.get_edges(idx(a), a["id"]),
                    "incoming": e.get_incoming_edges(idx(a), a["id"])}

        # ---- vectors/indexes --------------------------------------------
        @t("list_indexes", "List vector indexes", {})
        def list_indexes(a):
            return {"indexes": [e.index_info(n)
                                for n in e.list_indexes()]}

        @t("create_index", "Create a vector index",
           {"name": S, "metric": S, "precision": S, "kind": S,
            "shards": N})
        def create_index(a):
            e.create_index(a["name"], metric=a.get("metric", "cosine"),
                           precision=a.get("precision", "float32"),
                           kind=a.get("kind", "hnsw"),
                           shards=int(a.get("shards", 0)))
            return {"status": "ok"}

        @t("delete_index", "Drop a vector index", {"name": S})
        def delete_index(a):
            e.drop_index(a["name"])
            return {"status": "ok"}

        @t("filter_vectors", "List vectors matching a metadata filter",
           {"filter": S, "limit": N, "index": S})
        def filter_vectors(a):
            from ..engine import filters as filtlib
            name = idx(a)
            h = e._handle(name)
            rows = filtlib.evaluate(a.get("filter", ""), h.meta,
                                    e._live_rows(h))
            out = []
            for r in sorted(rows)[: int(a.get("limit", 50))]:
                ext = h.index.ids.row_to_ext[r]
                if ext:
                    out.append({"id": ext, "metadata": h.meta.get(r)})
            return {"vectors": out, "total": len(rows)}

        @t("list_vectors", "Page through vectors in an index",
           {"limit": N, "offset": N, "index": S})
        def list_vectors(a):
            name = idx(a)
            h = e._handle(name)
            if hasattr(h.index, "flush"):
                h.index.flush()
            ids = sorted(h.index.ids.ext_to_row)
            off = int(a.get("offset", 0))
            lim = int(a.get("limit", 50))
            return {"ids": ids[off:off + lim], "total": len(ids)}

        @t("search_with_scores", "Raw vector search with scores",
           {"query": S, "k": N, "index": S})
        def search_with_scores(a):
            hits = e.search(idx(a), embed(a["query"]),
                            k=int(a.get("k", 10)))[0]
            return {"results": hits}

        @t("assess_belief", "Epistemic belief assessment of a memory",
           {"id": S, "index": S})
        def assess_belief(a):
            from dataclasses import asdict
            return asdict(e.belief_state(idx(a), a["id"]))

        @t("configure_auto_links", "Set metadata-based auto-link rules",
           {"rules": A, "index": S})
        def configure_auto_links(a):
            e.configure_index(idx(a), {"auto_links": a.get("rules") or []})
            return {"status": "ok"}

        # ---- sessions & profiles ----------------------------------------
        @t("start_session", "Begin a working-memory session",
           {"user_id": S})
        def start_session(a):
            sid = f"sess_{uuid.uuid4().hex[:12]}"
            self.sessions[sid] = {"id": sid, "user_id": a.get("user_id"),
                                  "started": time.time(), "memories": []}
            return {"session_id": sid}

        @t("end_session", "End a session, consolidating its memories into "
           "a pinned summary node", {"session_id": S, "index": S})
        def end_session(a):
            """Session summarization on close (gardener.go:1563):
            deterministic extractive summary (LLM-refined when available)
            stored as a pinned node linked to the session memories."""
            s = self.sessions.pop(a["session_id"], None)
            if s is None:
                raise KeyError(f"no such session: {a['session_id']}")
            summary_id = None
            if s["memories"]:
                name = idx(a)
                contents = []
                for mid in s["memories"][:20]:
                    try:
                        m = e.get(name, mid)["metadata"]
                        if m.get("content"):
                            contents.append(str(m["content"]))
                    except KeyError:
                        pass
                if contents:
                    text = "Session summary: " + " • ".join(
                        c[:150] for c in contents)[:1500]
                    if self.gardener is not None and \
                            self.gardener.llm is not None:
                        refined = self.gardener._llm_consolidate(contents)
                        if refined:
                            text = f"Session summary: {refined}"
                    summary_id = f"sess_sum_{a['session_id'][-8:]}"
                    e.add(name, summary_id, embed(text),
                          {"content": text, "type": "session_summary",
                           "session_id": a["session_id"], "_pinned": True,
                           "_indexed_fields": ["content"]})
                    for mid in s["memories"][:20]:
                        try:
                            e.link(name, summary_id, "summarizes", mid)
                        except KeyError:
                            pass
            return {"status": "ended", "memories": len(s["memories"]),
                    "summary_id": summary_id}

        @t("list_sessions", "List active sessions", {})
        def list_sessions(a):
            return {"sessions": list(self.sessions.values())}

        @t("get_user_profile", "Fetch a stored user profile",
           {"user_id": S})
        def get_user_profile(a):
            raw = e.kv_get(f"profile:{a['user_id']}")
            if raw is None:
                raise KeyError(f"no profile for {a['user_id']}")
            return json.loads(raw)

        @t("list_user_profiles", "List stored user profiles", {})
        def list_user_profiles(a):
            return {"profiles": [json.loads(v)
                                 for _, v in e.kv_scan("profile:")]}

        @t("refresh_user_profile", "Rebuild a user profile from their "
           "memories (deterministic without an LLM)", {"user_id": S,
                                                       "index": S})
        def refresh_user_profile(a):
            if self.gardener is not None:
                return self.gardener.build_user_profile(a["user_id"],
                                                        idx(a))
            prof = {"user_id": a["user_id"], "confidence": 0.0,
                    "last_updated": int(time.time())}
            e.kv_set(f"profile:{a['user_id']}", json.dumps(prof))
            return prof

        @t("transfer_memory", "Copy memories between indexes",
           {"source_index": S, "target_index": S, "filter": S})
        def transfer_memory(a):
            src = e._handle(a["source_index"])
            if hasattr(src.index, "flush"):
                src.index.flush()
            if a["target_index"] not in e.indexes:
                info = e.index_info(a["source_index"])
                e.create_index(a["target_index"], metric=info["metric"],
                               precision=info["precision"])
            rows = e._live_rows(src)
            if a.get("filter"):
                from ..engine import filters as filtlib
                rows = filtlib.evaluate(a["filter"], src.meta, rows)
            ids, vecs, metas = [], [], []
            for r in sorted(rows):
                ext = src.index.ids.row_to_ext[r]
                if ext and ext not in e.indexes[a["target_index"]].index.ids:
                    v = src.index.get_vector(ext)
                    if v is not None:
                        ids.append(ext)
                        vecs.append(v)
                        metas.append(src.meta.get(r) or {})
            if ids:
                e.add_batch(a["target_index"], ids, np.stack(vecs), metas)
            return {"transferred": len(ids)}

        @t("adaptive_retrieve", "Graph-expanded retrieval within a token "
           "budget", {"query": S, "token_budget": N, "index": S})
        def adaptive_retrieve(a):
            from ..services.rag import AdaptiveRetriever
            r = AdaptiveRetriever(e, self.embedder)
            return r.retrieve(idx(a), a["query"],
                              token_budget=int(a.get("token_budget", 2000)))

        # ---- cognitive / gardener ---------------------------------------
        @t("check_subconscious", "List unresolved gardener reflections",
           {"index": S})
        def check_subconscious(a):
            if self.gardener is None:
                return {"reflections": []}
            return {"reflections": self.gardener.reflections(idx(a))}

        @t("resolve_conflict", "Resolve a gardener reflection",
           {"reflection_id": S, "resolution": S, "index": S})
        def resolve_conflict(a):
            if self.gardener is None:
                raise KeyError("gardener disabled")
            ok = self.gardener.resolve(idx(a), a["reflection_id"],
                                       a.get("resolution"))
            return {"resolved": bool(ok)}

        @t("trigger_reflection", "Trigger a gardener think cycle",
           {"index": S})
        def trigger_reflection(a):
            if self.gardener is None:
                return {"status": "gardener disabled"}
            return self.gardener.think(idx(a))

        @t("apply_reflection", "Execute a reflection's proposed action "
           "(e.g. merge a consolidation cluster)",
           {"reflection_id": S, "index": S})
        def apply_reflection(a):
            if self.gardener is None:
                raise KeyError("gardener disabled")
            return self.gardener.apply_reflection(idx(a),
                                                  a["reflection_id"])

        @t("consolidate_memories", "Merge near-duplicate memories into one "
           "pinned semantic memory", {"ids": {"type": "array"}, "index": S})
        def consolidate_memories(a):
            if self.gardener is None:
                raise KeyError("gardener disabled")
            cid = self.gardener.consolidate_cluster(idx(a),
                                                    list(a.get("ids") or []))
            return {"consolidated_id": cid}

        @t("resolve_beliefs", "Adjudicate contested/volatile beliefs via "
           "the epistemic engine", {"index": S})
        def resolve_beliefs(a):
            if self.gardener is None:
                return {"resolved": []}
            return {"resolved":
                    self.gardener.resolve_volatile_beliefs(idx(a))}

        @t("summarize_session", "Roll a session's memories into one pinned "
           "summary node", {"session_id": S, "index": S})
        def summarize_session_tool(a):
            if self.gardener is None:
                raise KeyError("gardener disabled")
            out = self.gardener.summarize_session(idx(a), a["session_id"])
            if out is None:
                raise KeyError("no memories for session")
            return out

        @t("ask_meta_question", "Ask about the memory system itself",
           {"question": S, "index": S})
        def ask_meta_question(a):
            name = idx(a)
            info = e.index_info(name)
            return {"answer": f"Index {name}: {info['size']} memories, "
                              f"metric={info['metric']}, "
                              f"deleted={info['deleted']}.",
                    "stats": info}

        @t("get_gardener_status", "Gardener daemon status", {})
        def get_gardener_status(a):
            if self.gardener is None:
                return {"enabled": False}
            return self.gardener.status()

        @t("list_reflections", "List reflections for an index",
           {"index": S})
        def list_reflections(a):
            if self.gardener is None:
                return {"reflections": []}
            return {"reflections": self.gardener.reflections(idx(a))}

        @t("request_knowledge", "Record a knowledge gap request",
           {"topic": S, "index": S})
        def request_knowledge(a):
            name = idx(a)
            rid = f"kreq_{uuid.uuid4().hex[:8]}"
            e.add(name, rid, embed(a["topic"]),
                  {"content": f"Knowledge request: {a['topic']}",
                   "type": "knowledge_request", "_pinned": True})
            return {"id": rid}

        # ---- artifacts / compiler ---------------------------------------
        @t("list_templates", "List knowledge-compiler templates", {})
        def list_templates(a):
            if self.compiler is None:
                return {"templates": []}
            return {"templates": self.compiler.templates()}

        @t("list_artifacts", "List compiled artifacts", {"index": S})
        def list_artifacts(a):
            if self.compiler is None:
                return {"artifacts": []}
            return {"artifacts": self.compiler.list_artifacts(
                a.get("index"))}

        @t("get_artifact_history", "Version history of an artifact",
           {"template": S, "entity_id": S, "index": S})
        def get_artifact_history(a):
            if self.compiler is None:
                return {"versions": []}
            return {"versions": self.compiler.history(
                a.get("template"), a.get("entity_id"), a.get("index"))}

        @t("get_artifact_staleness", "Staleness score of an artifact",
           {"template": S, "entity_id": S, "index": S})
        def get_artifact_staleness(a):
            if self.compiler is None:
                raise KeyError("compiler disabled")
            return self.compiler.staleness(a.get("template"),
                                           a.get("entity_id"),
                                           a.get("index"))

        @t("diff_artifact_versions", "Diff two artifact versions",
           {"template": S, "entity_id": S, "v1": N, "v2": N, "index": S})
        def diff_artifact_versions(a):
            if self.compiler is None:
                raise KeyError("compiler disabled")
            return self.compiler.diff(a.get("template"), a.get("entity_id"),
                                      int(a.get("v1", 1)),
                                      int(a.get("v2", 2)), a.get("index"))

        @t("force_recompile", "Force artifact recompilation",
           {"template": S, "entity_id": S, "index": S})
        def force_recompile(a):
            if self.compiler is None:
                raise KeyError("compiler disabled")
            return self.compiler.recompile(a.get("template"),
                                           a.get("entity_id"),
                                           a.get("index"))

        # ---- admin -------------------------------------------------------
        @t("save_snapshot", "Persist a checkpoint", {})
        def save_snapshot(a):
            return {"checkpoint": e.save_snapshot()}

        @t("compact_aof", "Compact the journal (snapshot + truncate)", {})
        def compact_aof(a):
            return {"checkpoint": e.save_snapshot()}

        @t("get_embedder_status", "Embedder provider status", {})
        def get_embedder_status(a):
            return self.embedder.status()

        @t("kv_get", "Read a KV key", {"key": S})
        def kv_get(a):
            v = e.kv_get(a["key"])
            if v is None:
                raise KeyError(f"no such key: {a['key']}")
            try:
                return {"key": a["key"], "value": v.decode()}
            except UnicodeDecodeError:
                import base64
                return {"key": a["key"],
                        "value_b64": base64.b64encode(v).decode()}

        @t("kv_set", "Write a KV key", {"key": S, "value": S})
        def kv_set(a):
            e.kv_set(a["key"], a.get("value", ""))
            return {"status": "ok"}

        @t("kv_delete", "Delete a KV key", {"key": S})
        def kv_delete(a):
            return {"deleted": e.kv_delete(a["key"])}

        @t("get_stats", "Engine statistics", {})
        def get_stats(a):
            return e.stats()

        @t("get_persistence_status", "Journal/checkpoint status", {})
        def get_persistence_status(a):
            return {"data_dir": e.config.data_dir,
                    "dirty_ops": e._dirty,
                    "aof_bytes": e._aof.size() if e._aof else 0}


def serve_stdio(engine, embedder=None, compiler=None, gardener=None,
                stdin=None, stdout=None) -> None:
    """Newline-delimited JSON-RPC 2.0 loop (internal/mcp/server.go:21)."""
    svc = MCPService(engine, embedder, compiler, gardener)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except ValueError:
            continue
        resp = handle_rpc(svc, req)
        if resp is not None:
            stdout.write(json.dumps(resp) + "\n")
            stdout.flush()


def handle_rpc(svc: MCPService, req: dict) -> Optional[dict]:
    rid = req.get("id")
    method = req.get("method", "")
    try:
        if method == "initialize":
            result = {
                "protocolVersion": "2024-11-05",
                "capabilities": {"tools": {}, "prompts": {}},
                "serverInfo": {"name": "kektordb-tpu",
                               "version": "0.1.0"}}
        elif method == "tools/list":
            result = {"tools": svc.list_tools()}
        elif method == "prompts/list":
            result = {"prompts": [{
                "name": "memory_instructions",
                "description": "How to use KektorDB memory tools "
                               "effectively"}]}
        elif method == "prompts/get":
            import os
            path = os.path.join(os.path.dirname(__file__),
                                "memory_instructions.md")
            with open(path) as f:
                text = f.read()
            result = {"description": "KektorDB memory instructions",
                      "messages": [{"role": "user", "content": {
                          "type": "text", "text": text}}]}
        elif method == "tools/call":
            params = req.get("params") or {}
            out = svc.call(params.get("name", ""),
                           params.get("arguments") or {})
            result = {"content": [{"type": "text",
                                   "text": json.dumps(out, default=str)}]}
        elif method in ("notifications/initialized", "ping"):
            return {"jsonrpc": "2.0", "id": rid, "result": {}} \
                if rid is not None else None
        else:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32601,
                              "message": f"unknown method {method}"}}
        return {"jsonrpc": "2.0", "id": rid, "result": result}
    except KeyError as e:
        return {"jsonrpc": "2.0", "id": rid,
                "error": {"code": -32602, "message": str(e).strip("'")}}
    except Exception as e:  # noqa: BLE001
        return {"jsonrpc": "2.0", "id": rid,
                "error": {"code": -32603, "message": str(e)}}
