"""Embedder registry.

Reference: pkg/embeddings — `Embedder{Embed(text) []float32}` (embedder.go:4)
with Ollama / OpenAI-compatible / Gemini / local-ONNX / Noop providers and a
unified `SelectEmbedder` factory with `auto` probing (select.go:92-206).

TPU-first replacements:
  local    → a MiniLM-class BERT encoder on the same card
             (services/minilm.py). Needs weights on disk: without them
             `auto` falls back to `hashing`.
  hashing  → deterministic feature-hash embedding (384-d, L2-normalized).
             Replaces NoopEmbedder (select.go:139) but actually carries
             signal: bag-of-words with signed hashing, so memory recall
             works out of the box without any model.
  ollama / openai / gemini → HTTP providers (network-gated).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional, Protocol, Sequence

import numpy as np

log = logging.getLogger("kektordb.embeddings")

DEFAULT_DIM = 384   # MiniLM-L6-v2 output size


class Embedder(Protocol):
    dim: int
    name: str

    def embed(self, text: str) -> np.ndarray: ...
    def embed_batch(self, texts: Sequence[str]) -> np.ndarray: ...


class _Base:
    dim = DEFAULT_DIM
    name = "base"

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def status(self) -> dict:
        return {"status": "ok", "provider": self.name, "dim": self.dim}

    def reload(self) -> None:
        pass


class HashingEmbedder(_Base):
    """Signed feature hashing over word 1-2-grams; deterministic, no model."""

    name = "hashing"

    def __init__(self, dim: int = DEFAULT_DIM):
        self.dim = dim

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            words = text.lower().split()
            grams = words + [" ".join(p) for p in zip(words, words[1:])]
            for g in grams:
                h = hashlib.blake2b(g.encode(), digest_size=8).digest()
                slot = int.from_bytes(h[:4], "little") % self.dim
                sign = 1.0 if h[4] & 1 else -1.0
                out[i, slot] += sign
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out


class MiniLMEmbedder(_Base):
    """BERT-family sentence encoder on `device` (services/minilm.py):
    all-MiniLM-*, bge-small/base (CLS pooling, auto-detected), gte/e5
    (mean pooling): any BERT-architecture sentence-transformers
    checkpoint.

    Weight resolution order: explicit weights_dir, then the kektordb model
    cache (services/download.py; safetensors), then the Hugging Face local
    cache, then a network fetch only when KEKTOR_ALLOW_DOWNLOAD=1."""

    name = "local"

    def __init__(self,
                 model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
                 weights_dir: Optional[str] = None,
                 pooling: Optional[str] = None, device="cuda"):
        from . import download
        from .minilm import MiniLMEncoder
        if weights_dir is None:
            weights_dir = download.local_model_dir(model_name)
        if weights_dir is None \
                and os.environ.get("KEKTOR_ALLOW_DOWNLOAD") == "1":
            weights_dir = download.fetch_model(model_name)
        self._enc = MiniLMEncoder(model_name, weights_dir=weights_dir,
                                  pooling=pooling, device=device)
        self.dim = self._enc.dim

    @classmethod
    def from_encoder(cls, enc) -> "MiniLMEmbedder":
        """An embedder over an encoder built another way (from_params)."""
        self = cls.__new__(cls)
        self._enc = enc
        self.dim = enc.dim
        return self

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return self._enc.encode(list(texts))

    def reload(self) -> None:
        self._enc.reload()


class HTTPEmbedder(_Base):
    """OpenAI-compatible /v1/embeddings provider (embeddings/openai.go)."""

    name = "openai"

    def __init__(self, base_url: str, model: str,
                 api_key: Optional[str] = None, dim: int = DEFAULT_DIM):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.dim = dim

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        import requests
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        r = requests.post(f"{self.base_url}/embeddings",
                          json={"model": self.model, "input": list(texts)},
                          headers=headers, timeout=60)
        r.raise_for_status()
        data = sorted(r.json()["data"], key=lambda d: d["index"])
        out = np.asarray([d["embedding"] for d in data], np.float32)
        self.dim = out.shape[1]
        return out


class OllamaEmbedder(HTTPEmbedder):
    name = "ollama"

    def __init__(self, base_url: str = "http://localhost:11434",
                 model: str = "nomic-embed-text"):
        super().__init__(base_url, model)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        import requests
        out = []
        for t in texts:
            r = requests.post(f"{self.base_url}/api/embeddings",
                              json={"model": self.model, "prompt": t},
                              timeout=60)
            r.raise_for_status()
            out.append(r.json()["embedding"])
        arr = np.asarray(out, np.float32)
        self.dim = arr.shape[1]
        return arr


class GeminiEmbedder(_Base):
    """Google embedContent provider (embeddings/gemini.go:16-127):
    x-goog-api-key auth, `{"content":{"parts":[{"text":...}]}}` payload,
    `{"embedding":{"values":[...]}}` response; key falls back to
    GEMINI_API_KEY then GOOGLE_API_KEY like the reference."""

    name = "gemini"

    def __init__(self, base_url: str = "", model: str = "",
                 api_key: Optional[str] = None, dim: int = DEFAULT_DIM):
        self.model = model or "gemini-embedding-001"
        resource = self._resource(self.model)
        self.base_url = (base_url.rstrip("/") or
                         "https://generativelanguage.googleapis.com/"
                         f"v1beta/{resource}:embedContent")
        self.api_key = api_key
        self.dim = dim

    @staticmethod
    def _resource(model: str) -> str:
        model = model.strip().lstrip("/")
        return model if model.startswith("models/") else f"models/{model}"

    def _key(self) -> str:
        return (self.api_key or os.environ.get("GEMINI_API_KEY")
                or os.environ.get("GOOGLE_API_KEY") or "")

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        import requests
        headers = {"Content-Type": "application/json"}
        if self._key():
            headers["x-goog-api-key"] = self._key()
        out = []
        for t in texts:     # embedContent is single-text (gemini.go:44-57)
            r = requests.post(
                self.base_url, headers=headers, timeout=60,
                json={"model": self._resource(self.model),
                      "content": {"parts": [{"text": t}]}})
            r.raise_for_status()
            body = r.json()
            if body.get("error"):
                raise RuntimeError(
                    f"gemini embedder provider error: "
                    f"{body['error'].get('message')}")
            vals = body.get("embedding", {}).get("values") or []
            if not vals:
                raise RuntimeError("gemini embedder returned no values")
            out.append(vals)
        arr = np.asarray(out, np.float32)
        self.dim = arr.shape[1]
        return arr


def select_embedder(provider: str = "auto", **kw) -> _Base:
    """SelectEmbedder factory (select.go:92-206). `auto` probes local model
    availability and falls back to hashing (the reference probes Ollama and
    falls back to Noop)."""
    if provider == "hashing" or provider == "noop":
        return HashingEmbedder()
    if provider == "local":
        return MiniLMEmbedder(**kw)
    if provider == "openai":
        return HTTPEmbedder(**kw)
    if provider == "ollama":
        return OllamaEmbedder(**kw)
    if provider == "gemini":
        return GeminiEmbedder(**kw)
    if provider == "auto":
        if os.environ.get("KEKTOR_EMBEDDER_URL"):
            return HTTPEmbedder(os.environ["KEKTOR_EMBEDDER_URL"],
                                os.environ.get("KEKTOR_EMBEDDER_MODEL",
                                               "text-embedding-3-small"),
                                os.environ.get("KEKTOR_EMBEDDER_KEY"))
        try:
            return MiniLMEmbedder(device=kw.get("device", "cuda"))
        except Exception as e:  # no cached weights / no transformers
            log.info("local embedder unavailable (%s); using hashing", e)
            return HashingEmbedder()
    raise ValueError(f"unknown embedder provider: {provider}")
