"""RAG: document loaders, ingestion pipeline, retrievers.

Reference: pkg/rag — file-watcher vectorizers (pipeline.go:106-718) with
prev/next graph links, loaders (loader_smart.go / loader_pdf_advanced.go /
loader_docx.go / loader_cli.go), splitters (splitter.go), and the
adaptive retriever (adaptive_retriever.go:101-478): seed search → graph BFS
expansion with edge-weighted score decay / greedy / density strategies →
token-budget context assembly with provenance.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..text.splitter import get_splitter

log = logging.getLogger("kektordb.rag")


# ---------------------------------------------------------------------------
# loaders (loader_smart.go:17-88 dispatch: CLI template → format-specific →
# plain text)
# ---------------------------------------------------------------------------

def load_file(path: str, cli_template: Optional[str] = None,
              cli_timeout: float = 60.0) -> Optional[str]:
    if cli_template:
        try:
            cmd = cli_template.replace("{{file_path}}", path)
            out = subprocess.run(cmd, shell=True, capture_output=True,
                                 timeout=cli_timeout, text=True)
            if out.returncode == 0 and out.stdout.strip():
                return out.stdout
        except Exception:
            pass  # silent fallback (loader_smart.go:60-88)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pdf":
        return _load_pdf(path)
    if ext == ".docx":
        return _load_docx(path)
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return None


def _load_pdf(path: str) -> Optional[str]:
    try:
        from pypdf import PdfReader
        return "\n\n".join(p.extract_text() or "" for p in
                           PdfReader(path).pages)
    except ImportError:
        log.warning("pypdf unavailable; skipping %s", path)
        return None


def _load_docx(path: str) -> Optional[str]:
    """DOCX XML extraction without python-docx (loader_docx.go behavior)."""
    import re
    import zipfile
    try:
        with zipfile.ZipFile(path) as z:
            xml = z.read("word/document.xml").decode("utf-8", "replace")
        text = re.sub(r"</w:p>", "\n", xml)
        return re.sub(r"<[^>]+>", "", text)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# ingestion pipeline (vectorizers)
# ---------------------------------------------------------------------------

@dataclass
class PipelineConfig:
    """One vectorizer from vectorizers.yaml
    (internal/server/vectorizer_config.go:23-113)."""
    name: str
    path: str                       # watched directory
    index: str
    splitter: str = "recursive"
    chunk_size: int = 1000
    chunk_overlap: int = 150
    glob: str = ""
    cli_loader: str = ""            # {{file_path}} template
    link_sequence: bool = True      # prev/next edges between chunks
    extract_entities: bool = False  # entity graph enrichment
    ocr_images: bool = False        # vision-LLM OCR for image files


class VectorizerService:
    """Scan → load → split → embed → add_batch with prev/next graph links
    (pipeline.go:106-718). Triggered manually or by the background loop."""

    IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".gif", ".webp")

    def __init__(self, engine, embedder,
                 pipelines: Optional[list[PipelineConfig]] = None,
                 llm=None, vision_llm=None):
        self.engine = engine
        self.embedder = embedder
        self.pipelines = {p.name: p for p in (pipelines or [])}
        self.llm = llm                  # entity extraction (optional)
        self.vision_llm = vision_llm    # image OCR (optional)
        self._seen: dict[str, dict[str, float]] = {}

    def list(self) -> list[dict]:
        return [{"name": p.name, "path": p.path, "index": p.index,
                 "splitter": p.splitter} for p in self.pipelines.values()]

    def add_pipeline(self, cfg: PipelineConfig) -> None:
        self.pipelines[cfg.name] = cfg

    def trigger(self, name: str) -> dict:
        p = self.pipelines.get(name)
        if p is None:
            raise KeyError(f"no such vectorizer: {name}")
        return self.ingest_dir(p)

    def ingest_dir(self, p: PipelineConfig) -> dict:
        seen = self._seen.setdefault(p.name, {})
        ingested = 0
        for root, _, files in os.walk(p.path):
            for fn in files:
                if p.glob and not _glob_match(fn, p.glob):
                    continue
                full = os.path.join(root, fn)
                mtime = os.path.getmtime(full)
                if seen.get(full) == mtime:
                    continue
                n = self.ingest_file(p, full)
                if n:
                    seen[full] = mtime
                    ingested += n
        return {"pipeline": p.name, "chunks": ingested}

    def ingest_file(self, p: PipelineConfig, path: str) -> int:
        if path.lower().endswith(self.IMAGE_EXTS):
            text = self._ocr_image(p, path)
        else:
            text = load_file(path, p.cli_loader or None)
        if not text or not text.strip():
            return 0
        if p.index not in self.engine.indexes:
            self.engine.create_index(p.index, metric="cosine")
        chunks = get_splitter(p.splitter)(text, p.chunk_size,
                                          p.chunk_overlap)
        if not chunks:
            return 0
        base = os.path.basename(path)
        ids = [f"{base}::chunk{i}" for i in range(len(chunks))]
        fresh = [(i, cid) for i, cid in enumerate(ids)
                 if cid not in self.engine.indexes[p.index].index.ids]
        if not fresh:
            return 0
        vecs = self.embedder.embed_batch([chunks[i] for i, _ in fresh])
        metas = [{"content": chunks[i], "source": path, "chunk_index": i,
                  "_indexed_fields": ["content"], "doc": base}
                 for i, _ in fresh]
        self.engine.add_batch(p.index, [cid for _, cid in fresh],
                              np.asarray(vecs, np.float32), metas)
        if p.link_sequence:
            for (i, cid), (j, nid) in zip(fresh, fresh[1:]):
                if j == i + 1:
                    self.engine.link(p.index, cid, "next", nid,
                                     inverse="prev")
        if p.extract_entities:
            for i, cid in fresh:
                self._link_entities(p.index, cid, chunks[i])
        return len(fresh)

    # -- vision OCR (pipeline.go image path / loader_pdf_advanced.go) --------

    def _ocr_image(self, p: PipelineConfig, path: str) -> Optional[str]:
        """Image → text via the vision LLM; silently skipped when OCR is
        disabled or no vision model is configured."""
        if not p.ocr_images or self.vision_llm is None:
            return None
        import base64
        try:
            with open(path, "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
            return self.vision_llm.chat_with_images(
                "Transcribe all text in this image. Output only the "
                "transcription.", "", [b64])
        except Exception:
            log.exception("vision OCR failed for %s", path)
            return None

    # -- entity extraction + auto-linking (pipeline.go:106-718) --------------

    def _extract_entities(self, text: str) -> list[str]:
        """LLM extraction when configured, deterministic fallback: repeated
        capitalized phrases (the reference's LLM prompt distilled to a
        heuristic so enrichment works without any model)."""
        if self.llm is not None:
            try:
                out = self.llm.chat(
                    "Extract the named entities (people, organizations, "
                    "places, products) from the text. Reply with a JSON "
                    "array of strings, nothing else.", text[:4000])
                import json as _json
                ents = _json.loads(out[out.index("["): out.rindex("]") + 1])
                return [str(e).strip() for e in ents if str(e).strip()][:16]
            except Exception:
                pass
        import re
        from collections import Counter
        # multi-word capitalized phrases, or repeated capitalized words
        phrases = re.findall(
            r"\b(?:[A-Z][a-zA-Z0-9]+(?:\s+[A-Z][a-zA-Z0-9]+)+)\b", text)
        singles = re.findall(r"(?<![.!?]\s)(?<!^)\b([A-Z][a-z]{2,})\b", text)
        counts = Counter(singles)
        ents = list(dict.fromkeys(phrases))
        ents += [w for w, c in counts.items() if c >= 2 and w not in ents]
        return ents[:16]

    def _link_entities(self, index: str, chunk_id: str, text: str) -> None:
        """Create/refresh zero-vector entity nodes and mention edges
        (the reference's auto-linking: chunk -mentions-> entity with the
        inverse mentioned_in)."""
        for ent in self._extract_entities(text):
            eid = "entity::" + ent.lower().replace(" ", "_")[:80]
            h = self.engine.indexes[index]
            if eid not in h.index.ids:
                try:
                    self.engine.add(index, eid,
                                    self.embedder.embed(ent),
                                    {"type": "entity", "name": ent,
                                     "_pinned": True})
                except KeyError:
                    pass
            self.engine.link(index, chunk_id, "mentions", eid,
                             inverse="mentioned_in")


def _glob_match(name: str, pattern: str) -> bool:
    import fnmatch
    return any(fnmatch.fnmatch(name, p.strip())
               for p in pattern.split(","))


# ---------------------------------------------------------------------------
# retrievers
# ---------------------------------------------------------------------------

def _tokens(text: str) -> int:
    return max(len(text) // 4, 1)     # chars/4 heuristic like the reference


class RAGService:
    """Standard retrieval + context assembly (POST /rag/retrieve)."""

    def __init__(self, engine, embedder,
                 vectorizers: Optional[VectorizerService] = None):
        self.engine = engine
        self.embedder = embedder
        self.vectorizers = vectorizers

    def _index_of(self, pipeline_name: Optional[str]) -> str:
        if pipeline_name and self.vectorizers and \
                pipeline_name in self.vectorizers.pipelines:
            return self.vectorizers.pipelines[pipeline_name].index
        if pipeline_name and pipeline_name in self.engine.indexes:
            return pipeline_name
        raise KeyError(f"no such pipeline or index: {pipeline_name}")

    def retrieve(self, pipeline_name: Optional[str], query: str,
                 k: int = 10, *, include_provenance: bool = False,
                 compress: bool = False) -> dict:
        index = self._index_of(pipeline_name)
        qv = self.embedder.embed(query)
        hits = self.engine.search(index, qv, k=k, text_query=query,
                                  include_metadata=True)[0]
        chunks, sources = [], []
        for h in hits:
            meta = h.get("metadata") or {}
            content = meta.get("content", "")
            if compress:
                from ..text.compressor import compress as comp
                content = comp(content)
            chunks.append(content)
            if include_provenance:
                sources.append({"id": h["id"],
                                "source": meta.get("source"),
                                "score": h["score"]})
        text = "\n\n".join(c for c in chunks if c)
        return {"results": [h["id"] for h in hits], "response": text,
                "sources": sources, "provenance": include_provenance,
                "confidence": float(np.mean([h["score"] for h in hits])
                                    if hits else 0.0),
                "total_tokens": _tokens(text)}

    def retrieve_adaptive(self, pipeline_name: Optional[str], query: str,
                          *, token_budget: int = 2000,
                          strategy: str = "score_decay") -> dict:
        index = self._index_of(pipeline_name)
        return AdaptiveRetriever(self.engine, self.embedder).retrieve(
            index, query, token_budget=token_budget, strategy=strategy)


class AdaptiveRetriever:
    """Seed search → graph expansion → token-budget assembly
    (adaptive_retriever.go:101-478).

    Strategies:
      score_decay — expanded chunk score = parent score * edge weight * decay
      greedy      — expand only the best frontier node each round
      density     — prefer nodes with more links into already-selected set
    """

    DECAY = 0.8

    def __init__(self, engine, embedder):
        self.engine = engine
        self.embedder = embedder

    def retrieve(self, index: str, query: str, *, token_budget: int = 2000,
                 k_seed: int = 5, max_hops: int = 2,
                 strategy: str = "score_decay") -> dict:
        qv = self.embedder.embed(query)
        seeds = self.engine.search(index, qv, k=k_seed, text_query=query,
                                   include_metadata=True)[0]
        scored: dict[str, float] = {h["id"]: h["score"] for h in seeds}
        meta_of: dict[str, dict] = {h["id"]: h.get("metadata") or {}
                                    for h in seeds}
        expanded = 0
        frontier = list(scored)
        for _ in range(max_hops):
            nxt = []
            if strategy == "greedy" and frontier:
                frontier = [max(frontier, key=lambda i: scored.get(i, 0))]
            for nid in frontier:
                for edge in self.engine.get_edges(index, nid):
                    tid = edge["target"]
                    if tid in scored:
                        continue
                    w = float(edge.get("weight", 1.0))
                    s = scored.get(nid, 0.0) * w * self.DECAY
                    if strategy == "density":
                        into = sum(
                            1 for e2 in self.engine.get_edges(index, tid)
                            if e2["target"] in scored)
                        s *= (1.0 + 0.2 * into)
                    scored[tid] = s
                    try:
                        meta_of[tid] = self.engine.get(
                            index, tid)["metadata"]
                    except KeyError:
                        meta_of[tid] = {}
                    nxt.append(tid)
                    expanded += 1
            frontier = nxt
            if not frontier:
                break

        # token-budget assembly, best-first (adaptive_retriever.go:380-478)
        order = sorted(scored.items(), key=lambda kv: -kv[1])
        chunks, used, total = [], [], 0
        for nid, score in order:
            content = (meta_of.get(nid) or {}).get("content", "")
            if not content:
                continue
            t = _tokens(content)
            if total + t > token_budget and chunks:
                continue
            total += t
            chunks.append(content)
            used.append({"id": nid, "score": round(score, 4),
                         "source": (meta_of.get(nid) or {}).get("source")})
            if total >= token_budget:
                break
        return {
            "context_text": "\n\n".join(chunks),
            "chunks_used": len(chunks),
            "total_tokens": total,
            "documents_used": len({u.get("source") for u in used}),
            "sources": used,
            "provenance": True,
            "expansion_stats": {"seed_chunks": len(seeds),
                                "expanded_chunks": expanded,
                                "total_evaluated": len(scored)},
        }
