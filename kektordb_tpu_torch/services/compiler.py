"""Knowledge compiler — compiled artifacts from memories + graph.

Reference: pkg/compiler — compile pipeline (compiler.go:124-206): template
resolve → graph/search source query → per-field deterministic
(deterministic.go: metadata / graph count / top entities / sentiment) or LLM
compile (llm_compile.go) → provenance + confidence per field → stored as a
pinned versioned graph node (store.go:14-294). 5 templates (template.go:273),
async tasks (async.go), and an artifact Watcher (watcher.go:66-390)
subscribing to the EventBus with staleness scoring, auto-recompile and a
30-day archive.

Artifacts serve as a semantic cache: a hit returns in <50 ms with zero LLM
tokens (DOCUMENTATION.md:59).
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .llm import clean_llm_json

log = logging.getLogger("kektordb.compiler")

ARTIFACT_TYPE = "artifact"
ARCHIVE_AFTER = 30 * 24 * 3600.0
STALE_THRESHOLD = 0.5


@dataclass
class FieldSpec:
    name: str
    source: str          # metadata | graph_count | top_entities | sentiment
                         # | recent | llm
    params: dict[str, Any] = field(default_factory=dict)
    prompt: str = ""     # llm source only


@dataclass
class Template:
    name: str
    description: str
    fields: list[FieldSpec]


def default_templates() -> dict[str, Template]:
    """The reference ships 5 built-in templates (template.go:273)."""
    return {t.name: t for t in [
        Template("entity_card", "Profile card for a graph entity", [
            FieldSpec("name", "metadata", {"key": "name"}),
            FieldSpec("entity_type", "metadata", {"key": "entity_type"}),
            FieldSpec("connection_count", "graph_count"),
            FieldSpec("top_connections", "top_entities", {"k": 5}),
            FieldSpec("sentiment", "sentiment"),
            FieldSpec("recent_mentions", "recent", {"k": 3}),
            FieldSpec("summary", "llm",
                      prompt="Summarize what is known about this entity "
                             "in 2 sentences."),
        ]),
        Template("topic_summary", "Digest of memories about a topic", [
            FieldSpec("memory_count", "graph_count"),
            FieldSpec("top_related", "top_entities", {"k": 5}),
            FieldSpec("sentiment", "sentiment"),
            FieldSpec("recent", "recent", {"k": 5}),
            FieldSpec("summary", "llm",
                      prompt="Summarize these memories about the topic."),
        ]),
        Template("session_digest", "What happened in a session", [
            FieldSpec("memory_count", "graph_count"),
            FieldSpec("recent", "recent", {"k": 10}),
            FieldSpec("summary", "llm",
                      prompt="Write a 3-bullet digest of this session."),
        ]),
        Template("user_profile_card", "Compiled user profile", [
            FieldSpec("preferences", "recent", {"k": 5}),
            FieldSpec("sentiment", "sentiment"),
            FieldSpec("summary", "llm",
                      prompt="Describe this user's preferences briefly."),
        ]),
        Template("failure_runbook", "Recurring failure analysis", [
            FieldSpec("occurrences", "graph_count"),
            FieldSpec("recent", "recent", {"k": 5}),
            FieldSpec("remediation", "llm",
                      prompt="Propose remediation steps for this recurring "
                             "failure."),
        ]),
    ]}


class KnowledgeCompiler:
    def __init__(self, engine, llm=None, embedder=None,
                 watch: bool = False):
        self.engine = engine
        self.llm = llm
        self.embedder = embedder
        self._templates = default_templates()
        self._stale: dict[str, float] = {}
        if watch:
            engine.events.on(self._on_event,
                             types={"vector.add", "vector.update",
                                    "edge.create", "edge.delete"})

    # ---------------------------------------------------------- templates

    def templates(self) -> list[dict]:
        return [{"name": t.name, "description": t.description,
                 "fields": [f.name for f in t.fields]}
                for t in self._templates.values()]

    # ------------------------------------------------------------ compile

    def compile(self, req: dict) -> dict:
        """POST /compile (compiler.go:124-206)."""
        tname = req.get("template", "entity_card")
        tpl = self._templates.get(tname)
        if tpl is None:
            raise KeyError(f"no such template: {tname}")
        index = req["index_name"]
        entity_id = (req.get("entity_id") or (req.get("sources") or {})
                     .get("entity_id") or req.get("name", ""))
        sources = self._gather_sources(index, entity_id, req)
        fields, provenance, confidences = {}, {}, {}
        for spec in tpl.fields:
            val, prov, conf = self._compile_field(spec, sources)
            if val is not None:
                fields[spec.name] = val
                provenance[spec.name] = prov
                confidences[spec.name] = conf
        art = self._store(index, tpl.name, entity_id, req.get("name", ""),
                          fields, provenance, confidences)
        return art

    def _gather_sources(self, index: str, entity_id: str,
                        req: dict) -> dict:
        e = self.engine
        out = {"index": index, "entity_id": entity_id, "memories": [],
               "edges": [], "incoming": [], "meta": {}}
        if entity_id and index in e.indexes:
            try:
                out["meta"] = e.get(index, entity_id)["metadata"]
            except KeyError:
                pass
            out["edges"] = e.get_edges(index, entity_id)
            out["incoming"] = e.get_incoming_edges(index, entity_id)
            nodes = e.graph.bfs([f"{index}/{entity_id}"], 1)
            h = e._handle(index)
            for n in list(nodes)[:50]:
                ext = n.split("/", 1)[-1]
                row = h.index.ids.get(ext)
                if row is not None:
                    m = h.meta.get(row) or {}
                    if m.get("content"):
                        out["memories"].append(
                            {"id": ext, "content": m["content"],
                             "created": m.get("_created_at")})
        query = req.get("query") or (req.get("sources") or {}).get("query")
        if query and self.embedder is not None and index in e.indexes:
            hits = e.search(index, self.embedder.embed(query), k=10,
                            text_query=query, include_metadata=True)[0]
            for hh in hits:
                m = hh.get("metadata") or {}
                if m.get("content"):
                    out["memories"].append(
                        {"id": hh["id"], "content": m["content"],
                         "created": m.get("_created_at")})
        return out

    def _compile_field(self, spec: FieldSpec, src: dict):
        """Deterministic compilers (deterministic.go) + optional LLM."""
        if spec.source == "metadata":
            v = src["meta"].get(spec.params.get("key", spec.name))
            return v, {"source": "metadata"}, 1.0 if v is not None else 0.0
        if spec.source == "graph_count":
            n = len(src["edges"]) + len(src["incoming"]) \
                or len(src["memories"])
            return n, {"source": "graph"}, 1.0
        if spec.source == "top_entities":
            k = int(spec.params.get("k", 5))
            from collections import Counter
            c = Counter(e_["target"] for e_ in src["edges"])
            c.update(e_["source"] for e_ in src["incoming"])
            return [t for t, _ in c.most_common(k)], {"source": "graph"}, 1.0
        if spec.source == "sentiment":
            from .gardener import Gardener
            texts = [m["content"] for m in src["memories"]]
            if not texts:
                return None, {}, 0.0
            g = Gardener.__new__(Gardener)        # lexicon only, no init
            score = float(np.mean([g._sentiment(t) for t in texts]))
            label = ("positive" if score > 0.2 else
                     "negative" if score < -0.2 else "neutral")
            return {"score": round(score, 3), "label": label}, \
                {"source": "sentiment_lexicon",
                 "memories": len(texts)}, 0.8
        if spec.source == "recent":
            k = int(spec.params.get("k", 5))
            mems = sorted(src["memories"],
                          key=lambda m: m.get("created") or 0,
                          reverse=True)[:k]
            return [{"id": m["id"], "content": m["content"][:200]}
                    for m in mems], {"source": "memories"}, 1.0
        if spec.source == "llm":
            if self.llm is None or not src["memories"]:
                return None, {}, 0.0
            try:
                ctx = "\n".join(f"- {m['content'][:300]}"
                                for m in src["memories"][:10])
                resp = self.llm.chat(spec.prompt, ctx)
                return resp.strip()[:1000], \
                    {"source": "llm", "memories": len(src["memories"])}, 0.7
            except Exception:
                return None, {}, 0.0
        return None, {}, 0.0

    # -------------------------------------------------------------- store

    def _artifact_key(self, template: str, entity_id: str) -> str:
        return f"artifact::{template}::{entity_id}"

    def _store(self, index: str, template: str, entity_id: str,
               name: str, fields: dict, provenance: dict,
               confidences: dict) -> dict:
        """Pinned versioned graph node (store.go:14-294)."""
        e = self.engine
        key = self._artifact_key(template, entity_id)
        prior = self.history(template, entity_id, index)
        version = (prior[0]["version"] + 1) if prior else 1
        art_id = f"{key}::v{version}"
        conf = (float(np.mean(list(confidences.values())))
                if confidences else 0.0)
        meta = {"type": ARTIFACT_TYPE, "template": template,
                "entity_id": entity_id, "artifact_name": name,
                "version": version, "fields": json.dumps(fields),
                "provenance": json.dumps(provenance),
                "confidence": conf, "_pinned": True,
                "compiled_at": time.time()}
        dim = e.indexes[index].index.dim or 8
        vec = np.zeros(dim, np.float32)
        if self.embedder is not None and self.embedder.dim == dim:
            vec = self.embedder.embed(json.dumps(fields)[:1000])
        e.add(index, art_id, vec, meta)
        if entity_id and entity_id in e.indexes[index].index.ids:
            e.link(index, art_id, "describes", entity_id)
        if prior:
            e.link(index, art_id, "supersedes", prior[0]["id"])
        self._stale.pop(key, None)
        return {"id": art_id, "template": template, "entity_id": entity_id,
                "version": version, "fields": fields,
                "provenance": provenance, "confidence": conf}

    # -------------------------------------------------------------- reads

    def _artifact_rows(self, index: Optional[str]):
        e = self.engine
        names = [index] if index else e.list_indexes()
        for nm in names:
            if nm not in e.indexes:
                continue
            h = e._handle(nm)
            for row, meta in list(h.meta.direct.items()):
                if meta.get("type") != ARTIFACT_TYPE:
                    continue
                ext = h.index.ids.row_to_ext[row] \
                    if row < len(h.index.ids.row_to_ext) else None
                if ext:
                    yield nm, ext, meta

    def list_artifacts(self, index: Optional[str] = None) -> list[dict]:
        latest: dict[str, dict] = {}
        for nm, ext, meta in self._artifact_rows(index):
            key = self._artifact_key(meta["template"], meta["entity_id"])
            cur = latest.get(key)
            if cur is None or meta["version"] > cur["version"]:
                latest[key] = {"id": ext, "index": nm,
                               "template": meta["template"],
                               "entity_id": meta["entity_id"],
                               "version": meta["version"],
                               "confidence": meta.get("confidence", 0)}
        return sorted(latest.values(), key=lambda a: a["id"])

    def get_artifact(self, template: str, *, index: Optional[str] = None,
                     entity_type: Optional[str] = None,
                     entity_id: Optional[str] = None) -> Optional[dict]:
        """Cache-hit read path (<50 ms, zero tokens)."""
        versions = self.history(template, entity_id, index)
        if not versions:
            return None
        v = versions[0]
        return {**v, "fields": json.loads(v["fields_json"]),
                "provenance": json.loads(v["prov_json"])}

    def history(self, template: Optional[str], entity_id: Optional[str],
                index: Optional[str]) -> list[dict]:
        out = []
        for nm, ext, meta in self._artifact_rows(index):
            if template and meta["template"] != template:
                continue
            if entity_id and meta["entity_id"] != entity_id:
                continue
            out.append({"id": ext, "index": nm, "version": meta["version"],
                        "template": meta["template"],
                        "entity_id": meta["entity_id"],
                        "confidence": meta.get("confidence", 0),
                        "compiled_at": meta.get("compiled_at"),
                        "fields_json": meta.get("fields", "{}"),
                        "prov_json": meta.get("provenance", "{}")})
        return sorted(out, key=lambda a: -a["version"])

    def diff(self, template: str, entity_id: str, v1: int, v2: int,
             index: Optional[str] = None) -> dict:
        versions = {v["version"]: v
                    for v in self.history(template, entity_id, index)}
        if v1 not in versions or v2 not in versions:
            raise KeyError("version not found")
        f1 = json.loads(versions[v1]["fields_json"])
        f2 = json.loads(versions[v2]["fields_json"])
        changed = {k: {"from": f1.get(k), "to": f2.get(k)}
                   for k in set(f1) | set(f2) if f1.get(k) != f2.get(k)}
        return {"v1": v1, "v2": v2, "changed": changed}

    # ----------------------------------------------------------- watcher

    def _on_event(self, ev) -> None:
        """Staleness scoring on writes; crossing the threshold triggers an
        auto-recompile (watcher.go:66-390)."""
        for art in self.list_artifacts(ev.index or None):
            if ev.node_id and ev.node_id == art["entity_id"]:
                key = self._artifact_key(art["template"], art["entity_id"])
                self._stale[key] = self._stale.get(key, 0.0) + 0.25
                if self._stale[key] >= STALE_THRESHOLD:
                    try:
                        self.recompile(art["template"], art["entity_id"],
                                       art["index"])
                    except Exception:
                        log.exception("auto-recompile failed for %s", key)

    def staleness(self, template: str, entity_id: str,
                  index: Optional[str] = None) -> dict:
        key = self._artifact_key(template, entity_id)
        score = min(self._stale.get(key, 0.0), 1.0)
        return {"template": template, "entity_id": entity_id,
                "staleness": score, "stale": score >= STALE_THRESHOLD}

    def recompile(self, template: str, entity_id: str,
                  index: Optional[str] = None) -> dict:
        versions = self.history(template, entity_id, index)
        if not versions:
            raise KeyError("no artifact to recompile")
        return self.compile({"template": template, "entity_id": entity_id,
                             "index_name": versions[0]["index"]})

    def sweep_archive(self) -> int:
        """Archive superseded versions older than 30 days
        (watcher.go 30-day archive)."""
        cutoff = time.time() - ARCHIVE_AFTER
        n = 0
        for art in list(self.list_artifacts(None)):
            for v in self.history(art["template"], art["entity_id"],
                                  art["index"])[1:]:
                if (v.get("compiled_at") or 0) < cutoff:
                    try:
                        self.engine.update_metadata(
                            v["index"], v["id"], {"_archived": True,
                                                  "_pinned": False})
                        n += 1
                    except KeyError:
                        pass
        return n
