"""Python SDK — full-surface HTTP client.

Reference: clients/python/kektordb_client/client.py (KektorDBClient, 1507
LoC) and pkg/client (Go SDK incl. Task.Wait polling, client.go:233-308).
Method names mirror the reference client's snake_case surface.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import requests


class KektorDBError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class Task:
    """Async-task handle with Wait polling (pkg/client/client.go:233-308)."""

    def __init__(self, client: "KektorDBClient", task_id: str):
        self.client = client
        self.id = task_id

    def status(self) -> dict:
        return self.client._get(f"/system/tasks/{self.id}")

    def wait(self, timeout: float = 300.0, interval: float = 0.25) -> dict:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.status()
            if st["status"] in ("completed", "failed"):
                if st["status"] == "failed":
                    raise KektorDBError(500, st.get("error") or "task failed")
                return st
            time.sleep(interval)
        raise TimeoutError(f"task {self.id} did not finish in {timeout}s")


class KektorDBClient:
    def __init__(self, base_url: str = "http://localhost:9091",
                 token: Optional[str] = None, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.session = requests.Session()
        if token:
            self.session.headers["Authorization"] = f"Bearer {token}"

    # ------------------------------------------------------------ plumbing

    def _req(self, method: str, path: str, **kw) -> Any:
        r = self.session.request(method, self.base_url + path,
                                 timeout=self.timeout, **kw)
        if r.status_code >= 400:
            try:
                msg = r.json().get("error", r.text)
            except ValueError:
                msg = r.text
            raise KektorDBError(r.status_code, msg)
        if r.status_code == 204 or not r.content:
            return None
        ctype = r.headers.get("Content-Type", "")
        return r.json() if "json" in ctype else r.content

    def _get(self, path: str, **kw):
        return self._req("GET", path, **kw)

    def _post(self, path: str, body: Optional[dict] = None, **kw):
        return self._req("POST", path, json=body, **kw)

    # -------------------------------------------------------------- system

    def health(self) -> dict:
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/system/stats")

    def save(self) -> dict:
        return self._post("/system/save")

    def aof_rewrite(self) -> dict:
        return self._post("/system/aof-rewrite")

    def metrics(self) -> str:
        return self._get("/metrics").decode()

    # ------------------------------------------------------------- indexes

    def vcreate(self, index_name: str, *, metric: str = "euclidean",
                precision: str = "float32", m: int = 16,
                ef_construction: int = 200, ef_search: int = 100,
                text_language: str = "english", kind: str = "hnsw",
                shards: int = 0, serve_mode: str = "auto",
                serve_proj_dim: int = 0,
                serve_proj_rerank: int = 128) -> dict:
        """kind: hnsw | flat | host; shards>1 row-shards over N devices;
        serve_mode: auto (scan-serve + graph) | scan | beam;
        serve_proj_dim: opt-in PCA-projected pass A (spectrally-decaying
        corpora only)."""
        return self._post("/vector/actions/create", {
            "index_name": index_name, "metric": metric,
            "precision": precision, "m": m,
            "ef_construction": ef_construction, "ef_search": ef_search,
            "text_language": text_language, "kind": kind,
            "shards": shards, "serve_mode": serve_mode,
            "serve_proj_dim": serve_proj_dim,
            "serve_proj_rerank": serve_proj_rerank})

    def list_indexes(self) -> list[dict]:
        return self._get("/vector/indexes")

    def index_info(self, name: str) -> dict:
        return self._get(f"/vector/indexes/{name}")

    def drop_index(self, name: str) -> None:
        self._req("DELETE", f"/vector/indexes/{name}")

    def configure_index(self, name: str, config: dict) -> dict:
        return self._post(f"/vector/indexes/{name}/config", config)

    def trigger_maintenance(self, name: str, kind: str = "refine") -> Task:
        out = self._post(f"/vector/indexes/{name}/maintenance",
                         {"type": kind})
        return Task(self, out["task_id"])

    def set_auto_links(self, name: str, rules: list[dict]) -> dict:
        return self._req("PUT", f"/vector/indexes/{name}/auto-links",
                         json={"rules": rules})

    def export_vectors(self, name: str, limit: int = 100,
                       offset: int = 0) -> dict:
        return self._get(f"/vector/indexes/{name}/export"
                         f"?limit={limit}&offset={offset}")

    # ------------------------------------------------------------- vectors

    def vadd(self, index_name: str, vec_id: str,
             vector: Sequence[float],
             metadata: Optional[dict] = None) -> dict:
        return self._post("/vector/actions/add", {
            "index_name": index_name, "id": vec_id,
            "vector": list(map(float, vector)), "metadata": metadata})

    def vadd_batch(self, index_name: str, items: list[dict]) -> dict:
        return self._post("/vector/actions/add-batch",
                          {"index_name": index_name, "vectors": items})

    def vimport(self, index_name: str, items: list[dict]) -> Task:
        out = self._post("/vector/actions/import",
                         {"index_name": index_name, "vectors": items})
        return Task(self, out["task_id"])

    def vimport_commit(self, index_name: str) -> Task:
        out = self._post("/vector/actions/import/commit",
                         {"index_name": index_name})
        return Task(self, out["task_id"])

    def vsearch(self, index_name: str,
                query_vector: Optional[Sequence[float]] = None,
                k: int = 10, *, filter: Optional[str] = None,
                text_query: Optional[str] = None, alpha: float = 0.5,
                ef_search: Optional[int] = None,
                graph_filter: Optional[dict] = None,
                hydrate: bool = False,
                hydrate_relations: bool = False) -> dict:
        """query_vector=None with text_query set runs a text-only (BM25)
        search — the reference's searchWithFusion text-only path."""
        body: dict[str, Any] = {
            "index_name": index_name, "k": k,
            "alpha": alpha, "hydrate": hydrate,
            "hydrate_relations": hydrate_relations}
        if query_vector is not None:
            body["query_vector"] = list(map(float, query_vector))
        if filter:
            body["filter"] = filter
        if text_query:
            body["text_query"] = text_query
        if ef_search:
            body["ef_search"] = ef_search
        if graph_filter:
            body["graph_filter"] = graph_filter
        return self._post("/vector/actions/search", body)

    def vsearch_batch(self, index_name: str,
                      query_vectors: Sequence[Sequence[float]],
                      k: int = 10, *, filter: Optional[str] = None,
                      text_query: Optional[str] = None, alpha: float = 0.5,
                      ef_search: Optional[int] = None,
                      hydrate: bool = False, columnar: bool = False,
                      binary_queries: bool = False,
                      binary_results: bool = False):
        """Batched search: [B, D] queries in ONE request → per-query hit
        lists (the serving-throughput API; single-query vsearch gets its
        batching from the server-side request coalescer instead).

        columnar=True returns {"ids", "scores", "distances"} parallel
        [B][<=k] arrays instead of per-hit dicts (~3x fewer wire bytes);
        binary_queries=True ships the queries as base64 raw f32 (skips
        JSON float parsing server-side — needs numpy);
        binary_results=True (implies columnar) asks for scores/distances
        as base64 raw f32, decoded here into [B, k] numpy arrays — the
        server falls back to list columnar when results are ragged."""
        body: dict[str, Any] = {
            "index_name": index_name, "k": k, "alpha": alpha,
            "hydrate": hydrate}
        if binary_results:
            columnar = True
            body["wire"] = "b64"
        if binary_queries:
            import base64

            import numpy as _np
            q = _np.asarray(query_vectors, "<f4")
            body["query_vectors_b64"] = base64.b64encode(
                q.tobytes()).decode()
            body["query_shape"] = list(q.shape)
        else:
            body["query_vectors"] = [list(map(float, q))
                                     for q in query_vectors]
        if columnar:
            body["columnar"] = True
        if filter:
            body["filter"] = filter
        if text_query:
            body["text_query"] = text_query
        if ef_search:
            body["ef_search"] = ef_search
        out = self._post("/vector/actions/search", body)
        if columnar and "scores_b64" in out:
            import base64

            import numpy as _np
            shape = out["shape"]
            if "ids_b64" in out:
                # ids ride the binary wire as one newline-joined UTF-8
                # blob (server falls back to a JSON array for ids that
                # embed a newline)
                flat = base64.b64decode(
                    out["ids_b64"]).decode("utf-8").split("\n")
                k = shape[1]
                ids = [flat[i * k:(i + 1) * k] for i in range(shape[0])]
            else:
                ids = out["ids"]
            out = {"ids": ids,
                   "scores": _np.frombuffer(
                       base64.b64decode(out["scores_b64"]),
                       "<f4").reshape(shape),
                   "distances": _np.frombuffer(
                       base64.b64decode(out["distances_b64"]),
                       "<f4").reshape(shape)}
        return out if columnar else out["results_batch"]

    def vsearch_with_scores(self, index_name: str,
                            query_vector: Sequence[float],
                            k: int = 10) -> list[dict]:
        return self._post("/vector/actions/search-with-scores", {
            "index_name": index_name, "k": k,
            "query_vector": list(map(float, query_vector))})

    def vdel(self, index_name: str, vec_id: str) -> dict:
        return self._post("/vector/actions/delete_vector",
                          {"index_name": index_name, "id": vec_id})

    def vget(self, index_name: str, vec_id: str) -> dict:
        return self._get(f"/vector/indexes/{index_name}/vectors/{vec_id}")

    def vget_batch(self, index_name: str, ids: list[str],
                   compress_context: bool = False) -> list[dict]:
        return self._post("/vector/actions/get-vectors", {
            "index_name": index_name, "ids": ids,
            "compress_context": compress_context})

    def vreinforce(self, index_name: str, ids: list[str]) -> dict:
        return self._post("/vector/actions/reinforce",
                          {"index_name": index_name, "ids": ids})

    def vcompress(self, index_name: str, precision: str) -> Task:
        out = self._post("/vector/actions/compress",
                         {"index_name": index_name, "precision": precision})
        return Task(self, out["task_id"])

    def vevolve(self, index_name: str, old_id: str,
                new_vector: Sequence[float], *,
                new_content: Optional[str] = None,
                new_metadata: Optional[dict] = None,
                reason: Optional[str] = None) -> dict:
        return self._post("/vector/actions/evolve", {
            "index_name": index_name, "old_id": old_id,
            "new_vector": list(map(float, new_vector)),
            "new_content": new_content, "new_metadata": new_metadata,
            "reason": reason})

    def belief_state(self, index_name: str, vec_id: str) -> dict:
        return self._post("/vector/actions/belief-assessment",
                          {"index_name": index_name, "id": vec_id})

    # --------------------------------------------------------------- graph

    def vlink(self, index_name: str, source_id: str, relation_type: str,
              target_id: str, *, weight: float = 1.0,
              props: Optional[dict] = None,
              inverse_relation_type: Optional[str] = None) -> dict:
        return self._post("/graph/actions/link", {
            "index_name": index_name, "source_id": source_id,
            "target_id": target_id, "relation_type": relation_type,
            "weight": weight, "props": props,
            "inverse_relation_type": inverse_relation_type})

    def vunlink(self, index_name: str, source_id: str, relation_type: str,
                target_id: str) -> dict:
        return self._post("/graph/actions/unlink", {
            "index_name": index_name, "source_id": source_id,
            "target_id": target_id, "relation_type": relation_type})

    def get_links(self, index_name: str, source_id: str,
                  relation_type: Optional[str] = None,
                  at_time: Optional[float] = None) -> dict:
        return self._post("/graph/actions/get-links", {
            "index_name": index_name, "source_id": source_id,
            "relation_type": relation_type, "at_time": at_time})

    def get_incoming(self, index_name: str, target_id: str,
                     relation_type: Optional[str] = None) -> dict:
        return self._post("/graph/actions/get-incoming", {
            "index_name": index_name, "target_id": target_id,
            "relation_type": relation_type})

    def traverse(self, index_name: str, start_id: str, path: str) -> dict:
        return self._post("/graph/actions/traverse", {
            "index_name": index_name, "start_id": start_id, "path": path})

    def extract_subgraph(self, index_name: str, root_id: str,
                         max_depth: int = 2,
                         relations: Optional[list[str]] = None) -> dict:
        return self._post("/graph/actions/extract-subgraph", {
            "index_name": index_name, "root_id": root_id,
            "max_depth": max_depth, "relations": relations or []})

    def find_path(self, index_name: str, source_id: str,
                  target_id: str) -> dict:
        return self._post("/graph/actions/find-path", {
            "index_name": index_name, "source_id": source_id,
            "target_id": target_id})

    def search_nodes(self, index_name: str,
                     property_filter: Optional[str] = None,
                     limit: int = 100) -> dict:
        return self._post("/graph/actions/search-nodes", {
            "index_name": index_name, "property_filter": property_filter,
            "limit": limit})

    # ------------------------------------------------------------------ KV

    def kv_set(self, key: str, value: bytes | str) -> None:
        data = value.encode() if isinstance(value, str) else value
        self._req("POST", f"/kv/{key}", data=data)

    def kv_get(self, key: str) -> bytes:
        return self._get(f"/kv/{key}")

    def kv_delete(self, key: str) -> None:
        self._req("DELETE", f"/kv/{key}")

    # ----------------------------------------------------------------- RAG

    def rag_retrieve(self, pipeline_name: str, query: str,
                     k: int = 10, include_provenance: bool = False) -> dict:
        return self._post("/rag/retrieve", {
            "pipeline_name": pipeline_name, "query": query, "k": k,
            "include_provenance": include_provenance})

    def rag_retrieve_adaptive(self, pipeline_name: str, query: str,
                              token_budget: int = 2000) -> dict:
        return self._post("/rag/retrieve-adaptive", {
            "pipeline_name": pipeline_name, "query": query,
            "token_budget": token_budget})

    # ---------------------------------------------------------- sessions

    def start_session(self, user_id: Optional[str] = None) -> str:
        return self._post("/sessions", {"user_id": user_id})["session_id"]

    def end_session(self, session_id: str) -> dict:
        return self._post(f"/sessions/{session_id}/end")

    def transfer_memory(self, source_index: str, target_index: str,
                        filter: Optional[str] = None) -> dict:
        return self._post("/transfer/memory", {
            "source_index": source_index, "target_index": target_index,
            "filter": filter})

    # --------------------------------------------------------- cognitive

    def reflections(self, index_name: str) -> list[dict]:
        return self._get(
            f"/vector/indexes/{index_name}/reflections")["reflections"]

    def resolve_reflection(self, index_name: str, reflection_id: str) -> dict:
        return self._post(f"/vector/indexes/{index_name}/reflections/"
                          f"{reflection_id}/resolve")

    def apply_reflection(self, index_name: str, reflection_id: str) -> dict:
        """Execute a reflection's proposed action (e.g. consolidation)."""
        return self._post(f"/vector/indexes/{index_name}/reflections/"
                          f"{reflection_id}/apply")

    def think(self, index_name: str) -> dict:
        return self._post(f"/vector/indexes/{index_name}/cognitive/think")

    def resolve_beliefs(self, index_name: str) -> dict:
        return self._post(
            f"/vector/indexes/{index_name}/cognitive/resolve-beliefs")

    def summarize_session(self, index_name: str, session_id: str) -> dict:
        return self._post("/cognitive/summarize-session", {
            "index_name": index_name, "session_id": session_id})

    # -------------------------------------------------------------- auth

    def create_api_key(self, role: str, namespaces: Optional[list] = None,
                       name: str = "") -> dict:
        return self._post("/auth/keys", {"role": role,
                                         "namespaces": namespaces,
                                         "name": name})

    def list_api_keys(self) -> dict:
        return self._get("/auth/keys")

    def revoke_api_key(self, key_id: str) -> None:
        self._req("DELETE", f"/auth/keys/{key_id}")
