"""Layered configuration for the server process.

Reference: layered config (SURVEY §5) — CLI flags/env (KEKTOR_PORT,
KEKTOR_DATA_DIR, KEKTOR_TOKEN; main.go:96-136) plus YAML files:
vectorizers.yaml (RAG pipelines), proxy.yaml (AI gateway), cognitive YAML
(gardener). Here one `kektor.yaml` carries every section; separate files
still load via their sections.

Example:

  embedder:
    provider: auto            # auto|hashing|local|openai|ollama
  llm:
    base_url: http://localhost:11434/v1
    model: llama3
  gardener:
    enabled: true
    mode: basic
    interval: 300
  vectorizers:
    - name: docs
      path: ./docs
      index: documents
      splitter: markdown
      glob: "*.md"
  proxy:
    upstream_url: http://localhost:8000/v1
    firewall_enabled: true
    rag_index: documents
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import yaml

log = logging.getLogger("kektordb.config")


def load_config(path: Optional[str]) -> dict[str, Any]:
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        return yaml.safe_load(f) or {}


def build_services(engine, cfg: dict[str, Any]) -> dict[str, Any]:
    """Instantiate the service graph from a config dict."""
    from ..services.embeddings import select_embedder
    emb_cfg = dict(cfg.get("embedder") or {})
    provider = emb_cfg.pop("provider", "auto")
    if provider in ("local", "auto"):
        emb_cfg.setdefault("device", str(engine.device))
    embedder = select_embedder(provider, **emb_cfg)

    llm = None
    llm_cfg = cfg.get("llm") or {}
    if llm_cfg.get("base_url"):
        from ..services.llm import OpenAICompatClient
        llm = OpenAICompatClient(llm_cfg["base_url"],
                                 llm_cfg.get("model", "default"),
                                 llm_cfg.get("api_key"))
    elif llm_cfg.get("gemini_api_key"):
        from ..services.llm import GeminiClient
        llm = GeminiClient(llm_cfg["gemini_api_key"],
                           llm_cfg.get("model", "gemini-2.0-flash"))

    gardener = None
    g_cfg = cfg.get("gardener") or {}
    if g_cfg.get("enabled", True):
        from ..services.gardener import Gardener, GardenerConfig
        gardener = Gardener(
            engine, llm,
            GardenerConfig(
                mode=g_cfg.get("mode", "basic"),
                interval=float(g_cfg.get("interval", 300.0)),
                early_think_writes=int(g_cfg.get("early_think_writes", 50)),
                similarity_threshold=float(
                    g_cfg.get("similarity_threshold", 0.88))),
            embedder=embedder)

    from ..services.compiler import KnowledgeCompiler
    compiler = KnowledgeCompiler(engine, llm, embedder, watch=True)

    from ..services.rag import PipelineConfig, RAGService, VectorizerService
    pipelines = [PipelineConfig(**p) for p in cfg.get("vectorizers") or []]
    vectorizers = VectorizerService(engine, embedder, pipelines)
    rag = RAGService(engine, embedder, vectorizers)

    gateway = None
    p_cfg = cfg.get("proxy") or {}
    if p_cfg:
        from ..services.proxy import AIGateway, ProxyConfig
        gateway = AIGateway(engine, embedder,
                            ProxyConfig(**p_cfg), fast_llm=llm,
                            smart_llm=llm)

    return {"embedder": embedder, "llm": llm, "gardener": gardener,
            "compiler": compiler, "rag": rag, "vectorizers": vectorizers,
            "gateway": gateway}
