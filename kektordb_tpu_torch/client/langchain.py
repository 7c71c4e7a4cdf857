"""LangChain-compatible VectorStore wrapper.

Reference: clients/python/kektordb_client/langchain.py (KektorVectorStore).
Implements the langchain_core VectorStore duck-type (add_texts,
similarity_search, similarity_search_with_score, delete, from_texts) without
importing langchain — the returned Document objects are plain namespaces
unless langchain is installed."""

from __future__ import annotations

import uuid
from typing import Any, Callable, Iterable, Optional, Sequence

from .client import KektorDBClient


def _document(page_content: str, metadata: dict):
    try:
        from langchain_core.documents import Document
        return Document(page_content=page_content, metadata=metadata)
    except ImportError:
        from types import SimpleNamespace
        return SimpleNamespace(page_content=page_content, metadata=metadata)


class KektorVectorStore:
    def __init__(self, client: KektorDBClient, index_name: str,
                 embedding: Optional[Any] = None):
        self.client = client
        self.index_name = index_name
        self.embedding = embedding
        try:
            client.index_info(index_name)
        except Exception:
            client.vcreate(index_name, metric="cosine")

    def _embed(self, texts: list[str]) -> list[list[float]]:
        if self.embedding is not None:
            if hasattr(self.embedding, "embed_documents"):
                return self.embedding.embed_documents(texts)
            return [self.embedding.embed(t).tolist() for t in texts]
        from ..services.embeddings import HashingEmbedder
        emb = HashingEmbedder()
        return [emb.embed(t).tolist() for t in texts]

    def add_texts(self, texts: Iterable[str],
                  metadatas: Optional[list[dict]] = None,
                  ids: Optional[list[str]] = None) -> list[str]:
        texts = list(texts)
        ids = ids or [f"doc_{uuid.uuid4().hex[:12]}" for _ in texts]
        metadatas = metadatas or [{} for _ in texts]
        vectors = self._embed(texts)
        items = []
        for i, (t, m, vid) in enumerate(zip(texts, metadatas, ids)):
            meta = dict(m)
            meta["content"] = t
            meta["_indexed_fields"] = ["content"]
            items.append({"id": vid, "vector": vectors[i],
                          "metadata": meta})
        self.client.vadd_batch(self.index_name, items)
        return ids

    def similarity_search_with_score(self, query: str, k: int = 4,
                                     filter: Optional[str] = None):
        qv = self._embed([query])[0]
        out = self.client.vsearch(self.index_name, qv, k=k, filter=filter,
                                  text_query=query, hydrate=True)
        docs = []
        for hit in out["results"]:
            meta = hit.get("metadata") or {}
            docs.append((_document(meta.get("content", ""), meta),
                         hit.get("score", 0.0)))
        return docs

    def similarity_search(self, query: str, k: int = 4,
                          filter: Optional[str] = None):
        return [d for d, _ in
                self.similarity_search_with_score(query, k, filter)]

    def delete(self, ids: Optional[list[str]] = None) -> bool:
        for vid in ids or []:
            self.client.vdel(self.index_name, vid)
        return True

    @classmethod
    def from_texts(cls, texts: list[str], embedding=None,
                   metadatas: Optional[list[dict]] = None,
                   client: Optional[KektorDBClient] = None,
                   index_name: str = "langchain",
                   **kw) -> "KektorVectorStore":
        store = cls(client or KektorDBClient(), index_name, embedding)
        store.add_texts(texts, metadatas)
        return store
