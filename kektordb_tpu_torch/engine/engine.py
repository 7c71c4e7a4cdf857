"""Engine, in memory: the PyTorch port of kektordb_tpu/engine/engine.py.

Indexes, metadata, the knowledge graph and the KV store, behind one
readers-writer lock. A search settles pending writes under the exclusive
side, then runs the device search under the shared side, so concurrent
readers do not serialize.

Not ported yet, and refused with NotImplementedError (ROADMAP.md, queue 1,
item numbers in the messages): persistence (`data_dir`: AOF and
checkpoints), sharded indexes (`shards > 1`), host-arena indexes
(`kind="host"`), text and decay fusion (`text_query`, memory decay), and
every option the index refuses (`serve_proj_dim`). Without persistence
nothing is journaled.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass
from typing import Any, Optional, Sequence

import numpy as np

from .. import device as devlib
from ..index.base import IDMap
from ..index.bruteforce import BruteForceIndex
from ..index.hnsw import HNSWConfig, HNSWIndex, check_supported
from ..ops import distance as dist
from . import filters as filtlib
from . import fusion
from .events import Event, EventBus
from .graph import KnowledgeGraph
from .kv import KVStore
from .locks import RWLock
from .metadata import MetadataStore

log = logging.getLogger("kektordb")

GRAPH_DEPTH_CLAMP = 5  # resolveGraphFilter depth clamp (engine/graph.go:173)


@dataclass
class EngineConfig:
    device: str = "cuda"                    # raises if CUDA is absent
    data_dir: Optional[str] = None          # persistence: not ported yet
    maintenance_interval: float = 10.0      # maintenance tick
    graph_vacuum_interval: float = 3600.0   # hourly graph vacuum
    start_background: bool = True


class IndexHandle:
    """One named vector index + its metadata store + config."""

    def __init__(self, name: str, index, language: str = "english"):
        self.name = name
        self.index = index
        self.meta = MetadataStore(language)
        self.memory = fusion.MemoryConfig()
        self.language = language
        # allow-mask cache: (predicate/graph key + store versions) ->
        # (host mask, device mask). A cached device mask also skips the
        # [cap] host-to-device upload per request. Bounded LRU.
        self.mask_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.mask_hits = 0
        self.mask_misses = 0


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        if self.config.data_dir:
            raise NotImplementedError(
                "data_dir: the AOF journal and checkpoints "
                "(persist/index_io) are not ported yet "
                "(ROADMAP.md, queue 1, item 9)")
        self.device = devlib.resolve(self.config.device)
        self.indexes: dict[str, IndexHandle] = {}
        self.kv = KVStore()
        self.graph = KnowledgeGraph()
        self.events = EventBus()
        # `with self._lock` = exclusive write side; searches take
        # `self._lock.read()`
        self._lock = RWLock()
        self._dirty = 0
        self._stop = threading.Event()
        self._bg: Optional[threading.Thread] = None
        self._opened = False

    # ------------------------------------------------------------------ open

    def open(self) -> "Engine":
        with self._lock:
            if self._opened:
                return self
            if self.config.start_background:
                self._stop.clear()
                self._bg = threading.Thread(target=self._background,
                                            daemon=True)
                self._bg.start()
            self._opened = True
        return self

    def close(self) -> None:
        self._stop.set()
        if self._bg:
            self._bg.join(timeout=5.0)
            self._bg = None
        with self._lock:
            self._opened = False

    # -------------------------------------------------------- index mgmt

    def create_index(self, name: str, *, metric: str = dist.L2,
                     precision: str = dist.F32, m: int = 16,
                     ef_construction: int = 200, ef_search: int = 100,
                     language: str = "english", kind: str = "hnsw",
                     seed: int = 42, shards: int = 0,
                     serve_mode: str = "auto",
                     serve_proj_dim: Optional[int] = None) -> None:
        """VCREATE. Duplicate names are an error. Kinds "hnsw" (serve_mode
        "auto", "scan" or "beam") and "flat" are ported."""
        with self._lock:
            if name in self.indexes:
                raise KeyError(f"index already exists: {name}")
            if kind not in ("hnsw", "flat", "host"):
                raise ValueError(f"unknown index kind: {kind}")
            if metric not in dist.METRICS:
                raise ValueError(f"unknown metric {metric!r}")
            if precision not in dist.PRECISIONS:
                raise ValueError(f"unknown precision {precision!r}")
            if kind == "host":
                raise NotImplementedError(
                    "kind='host' (index/hostarena) is not ported yet "
                    "(ROADMAP.md, queue 1, item 10)")
            if shards > 1:
                raise NotImplementedError(
                    "shards > 1 (parallel/sharded) is not ported yet "
                    "(ROADMAP.md, queue 1, item 12)")
            cfg = HNSWConfig(m=m, ef_construction=ef_construction,
                             ef_search=ef_search, seed=seed,
                             serve_mode=serve_mode,
                             serve_proj_dim=serve_proj_dim or 0)
            if kind == "hnsw":
                check_supported(cfg)
            # the dimension is fixed by the first add
            self.indexes[name] = IndexHandle(
                name, _LazyIndex(metric, precision, cfg, kind=kind),
                language=language)
            self._dirty += 1

    def drop_index(self, name: str) -> None:
        with self._lock:
            if name not in self.indexes:
                raise KeyError(f"no such index: {name}")
            del self.indexes[name]
            self._dirty += 1

    def list_indexes(self) -> list[str]:
        return sorted(self.indexes)

    def index_info(self, name: str) -> dict[str, Any]:
        h = self._handle(name)
        idx = h.index
        with self._lock.read():   # text.stats() iterates write-hot dicts
            return {
                "name": name, "size": len(idx), "metric": idx.metric,
                "precision": idx.precision, "dimensions": idx.dim,
                "deleted": getattr(idx, "deleted_count", 0),
                "needs_refine": getattr(idx, "needs_refine", False),
                "serve_mode": getattr(getattr(idx, "config", None),
                                      "serve_mode", ""),
                "shards": 0,
                "config": asdict(idx.config) if hasattr(idx, "config")
                else {},
                "memory": asdict(h.memory),
                "memory_report": idx.memory_report()
                if hasattr(idx, "memory_report") else {},
                "text": h.meta.text.stats(),
                "mask_cache": {"entries": len(h.mask_cache),
                               "hits": h.mask_hits,
                               "misses": h.mask_misses},
            }

    def _handle(self, name: str) -> IndexHandle:
        h = self.indexes.get(name)
        if h is None:
            raise KeyError(f"no such index: {name}")
        return h

    # ----------------------------------------------------------- write path

    def add(self, index: str, ext_id: str, vector: Sequence[float],
            metadata: Optional[dict[str, Any]] = None) -> None:
        """VADD: index insert -> metadata -> event."""
        h = self._handle(index)
        vec = np.asarray(vector, np.float32).reshape(-1)
        meta = dict(metadata or {})
        with self._lock:
            self._ensure_materialized(h, vec.shape[-1])
            self._validate_add(h, [ext_id], vec[None, :])
            self._stamp_memory(h, meta)
            h.index.add(ext_id, vec)
            self._dirty += 1
            if meta:
                row = self._row_of(h, ext_id)
                if row is not None:
                    h.meta.set(row, meta)
        self.events.emit(Event("vector.add", index, ext_id))

    def add_batch(self, index: str, ext_ids: Sequence[str],
                  vectors: np.ndarray,
                  metadatas: Optional[Sequence[Optional[dict]]] = None,
                  fast: bool = False) -> None:
        """VAddBatch: bulk device build, then per-item metadata."""
        h = self._handle(index)
        vectors = np.asarray(vectors, np.float32)
        metas = [dict(m or {}) for m in
                 (metadatas if metadatas else [None] * len(ext_ids))]
        with self._lock:
            if len(ext_ids):
                self._ensure_materialized(h, vectors.shape[-1])
                self._validate_add(h, ext_ids, vectors)
            for m in metas:
                self._stamp_memory(h, m)
            h.index.add_batch(ext_ids, vectors, fast=fast)
            self._dirty += len(ext_ids)
            pairs = [(r, m) for e, m in zip(ext_ids, metas) if m
                     and (r := self._row_of(h, e)) is not None]
            if pairs:
                h.meta.set_batch([r for r, _ in pairs],
                                 [m for _, m in pairs])
        for e in ext_ids:
            self.events.emit(Event("vector.add", index, e))

    def import_batch(self, index: str, ext_ids: Sequence[str],
                     vectors: np.ndarray,
                     metadatas: Optional[Sequence[Optional[dict]]] = None
                     ) -> None:
        """VImport: a fast graph build, then a full refine (no journal;
        persistence is not ported)."""
        h = self._handle(index)
        self.add_batch(index, ext_ids, vectors, metadatas, fast=True)
        with self._lock:
            if hasattr(h.index, "turbo_refine"):
                h.index.turbo_refine()

    def delete(self, index: str, ext_id: str) -> bool:
        """VDEL: soft delete + metadata and graph-node removal."""
        h = self._handle(index)
        with self._lock:
            row = self._row_of(h, ext_id)
            ok = h.index.delete(ext_id)
            if ok and row is not None:
                h.meta.remove(row)
                self.graph.drop_node(f"{index}/{ext_id}")
            self._dirty += 1
        if ok:
            self.events.emit(Event("vector.delete", index, ext_id))
        return ok

    def update_metadata(self, index: str, ext_id: str,
                        patch: dict[str, Any]) -> None:
        """VMETA: merge a metadata patch."""
        h = self._handle(index)
        with self._lock:
            row = self._row_of(h, ext_id)
            if row is None:
                raise KeyError(f"no such id: {ext_id}")
            h.meta.update(row, patch)
            self._dirty += 1
        self.events.emit(Event("vector.update", index, ext_id))

    def get(self, index: str, ext_id: str) -> dict[str, Any]:
        h = self._handle(index)
        row = self._row_of(h, ext_id)
        if row is None:
            raise KeyError(f"no such id: {ext_id}")
        return {"id": ext_id, "metadata": h.meta.get(row) or {}}

    def _validate_add(self, h: IndexHandle, ext_ids: Sequence[str],
                      vectors: np.ndarray) -> None:
        """Duplicate-id and dimension checks before any write."""
        idx = h.index
        if idx.dim and vectors.shape[-1] != idx.dim:
            raise ValueError(
                f"expected dim {idx.dim}, got {vectors.shape[-1]}")
        seen: set[str] = set()
        for e in ext_ids:
            if e in idx.ids or e in seen:
                raise KeyError(f"id already present: {e}")
            seen.add(e)

    def _ensure_materialized(self, h: IndexHandle, dim: int) -> None:
        """The first insert fixes the dimension."""
        if not isinstance(h.index, _LazyIndex):
            return
        lazy = h.index
        if lazy.kind == "flat":
            h.index = BruteForceIndex(dim, lazy.metric, lazy.precision,
                                      device=self.device)
        else:
            h.index = HNSWIndex(dim, lazy.metric, lazy.precision, lazy.config,
                                device=self.device)

    def _stamp_memory(self, h: IndexHandle, meta: dict[str, Any]) -> None:
        """Memory timestamping + layer defaults (ops.go:274-317)."""
        if fusion.CREATED_KEY not in meta:
            meta[fusion.CREATED_KEY] = time.time()
        layer = meta.get(fusion.LAYER_KEY)
        if layer and layer in h.memory.layers:
            lc = h.memory.layers[layer]
            if lc.pinned_by_default and fusion.PINNED_KEY not in meta:
                meta[fusion.PINNED_KEY] = True

    def _row_of(self, h: IndexHandle, ext_id: str) -> Optional[int]:
        return h.index.ids.get(ext_id)

    # ----------------------------------------------------------- query path

    def search(self, index: str, query: Sequence[float] | np.ndarray,
               k: int = 10, *,
               ef: Optional[int] = None,
               filter: Optional[str] = None,
               text_query: Optional[str] = None,
               alpha: float = 0.5,
               graph_root: Optional[str] = None,
               graph_depth: int = 2,
               graph_relation: Optional[str] = None,
               at_time: Optional[float] = None,
               include_metadata: bool = False,
               decay: bool = True,
               columnar: bool = False):
        """Filter -> allow rows; graph BFS -> intersect; vector search;
        min-max normalized scores; top-k. Accepts [D] or [B, D]; returns a
        list of per-query hit lists, or with columnar=True
        {"ids", "scores", "distances"[, "metadata"]} ([B][<=k] lists;
        columnar="np" keeps scores and distances as [B, k] float32 arrays
        when every hit resolves)."""
        if text_query:
            raise NotImplementedError(
                "text_query: hybrid text fusion (ops/fuse.py) is not "
                "ported yet (ROADMAP.md, queue 1, item 8)")
        h = self._handle(index)
        if decay and h.memory.enabled:
            raise NotImplementedError(
                "memory decay (ops/fuse.py) is not ported yet "
                "(ROADMAP.md, queue 1, item 8)")
        q = np.atleast_2d(np.asarray(query, np.float32))
        B = q.shape[0]
        idx = h.index
        if idx.dim and q.shape[-1] != idx.dim:
            raise ValueError(
                f"query dim {q.shape[-1]} != index dim {idx.dim}")
        kwargs = dict(ef=ef, filter=filter, graph_root=graph_root,
                      graph_depth=graph_depth, graph_relation=graph_relation,
                      at_time=at_time, include_metadata=include_metadata,
                      index=index, columnar=columnar)
        # settle pending writes under the EXCLUSIVE side, then search
        # under the SHARED side; a writer slipping in between forces a
        # retry
        for _ in range(8):
            with self._lock:
                idx = h.index
                settle = getattr(idx, "settle_for_serving", None)
                if settle is not None:
                    settle()
            with self._lock.read():
                if idx is not h.index:
                    continue                      # index swapped under us
                dirty = getattr(idx, "serving_dirty", None)
                if dirty is not None and dirty():
                    continue                      # writer snuck in: retry
                return self._search_locked(h, idx, q, B, k, **kwargs)
        with self._lock:          # pathological write pressure: go exclusive
            return self._search_locked(h, h.index, q, B, k, **kwargs)

    def _search_locked(self, h, idx, q, B, k, *, ef, filter, graph_root,
                       graph_depth, graph_relation, at_time,
                       include_metadata, index, columnar=False):
        cap = _cap_of(idx)
        live = idx.ids.live_mask(cap)
        allow: Optional[np.ndarray] = None
        allow_dev = None
        if filter or graph_root:
            key = (filter, graph_root, graph_depth, graph_relation, at_time,
                   h.meta.version if filter else -1,
                   self.graph.version if graph_root else -1,
                   idx.ids.version, cap)
            ent = h.mask_cache.get(key)
            if ent is None:
                h.mask_misses += 1
                if filter:
                    allow = filtlib.evaluate_mask(filter, h.meta, live)
                if graph_root:
                    nodes = self.graph.bfs(
                        [f"{index}/{graph_root}"],
                        min(graph_depth, GRAPH_DEPTH_CLAMP),
                        relation=graph_relation, at_time=at_time)
                    gmask = np.zeros(cap, bool)
                    for nid in nodes:
                        if nid.startswith(index + "/"):
                            r = idx.ids.get(nid.split("/", 1)[1])
                            if r is not None and r < cap:
                                gmask[r] = True
                    allow = gmask if allow is None else (allow & gmask)
                prep = getattr(idx, "prepare_allow", None)
                ent = (allow, prep(allow) if prep is not None else None)
                h.mask_cache[key] = ent
                while len(h.mask_cache) > 32:
                    try:
                        h.mask_cache.popitem(last=False)
                    except KeyError:     # raced with another reader's evict
                        break
            else:
                h.mask_hits += 1
                try:
                    h.mask_cache.move_to_end(key)
                except KeyError:     # raced with an eviction: harmless
                    pass
            allow, allow_dev = ent
        if len(idx) == 0:
            return _empty_hits(B, include_metadata, columnar)
        d, rows_out = idx.search(
            q, max(k, ef or 0), ef=ef,
            allow_rows=allow_dev if allow_dev is not None else allow)
        return self._assemble_fast(h, idx, np.asarray(d, np.float32),
                                   np.asarray(rows_out, np.int64), B, k,
                                   include_metadata, columnar=columnar)

    def _assemble_fast(self, h, idx, d: np.ndarray, rows_out: np.ndarray,
                       B: int, k: int, include_metadata: bool,
                       columnar: bool = False):
        """Pure-vector result assembly (minmax_normalize semantics,
        search_utils.go:48-72, vectorized over the batch)."""
        valid = rows_out >= 0
        dm = np.where(valid, d, np.nan)
        # all-invalid rows (a filter that matches nothing) are pinned to 0
        all_nan = ~valid.any(axis=1, keepdims=True)
        dm = np.where(all_nan, 0.0, dm)
        with np.errstate(invalid="ignore"):
            lo = np.nanmin(dm, axis=1, keepdims=True)
            hi = np.nanmax(dm, axis=1, keepdims=True)
        span = hi - lo
        ok_span = span > 0
        scores = np.where(ok_span, (hi - d) / np.where(ok_span, span, 1.0),
                          1.0)
        row_to_ext = idx.ids.row_to_ext
        n_rows = len(row_to_ext)
        get_meta = h.meta.get
        if columnar:
            # common case: every one of the first k candidates maps to a
            # live id -> one fancy-index on the object-dtype id mirror
            safe = np.clip(rows_out, 0, max(n_rows - 1, 0))
            live = idx.ids.live_mask(max(n_rows, 1))
            ok = (rows_out >= 0) & (rows_out < n_rows) & live[safe]
            rect = rows_out.shape[1] >= k and bool(ok[:, :k].all())
            if rect and columnar == "np" and not include_metadata:
                ext_arr = idx.ids.exts_array()
                return {"ids": ext_arr[safe[:, :k]].tolist(),
                        "scores": np.ascontiguousarray(
                            scores[:, :k], np.float32),
                        "distances": np.ascontiguousarray(
                            d[:, :k], np.float32)}
            d_r = d.astype(np.float64).round(5)
            s_r = scores.astype(np.float64).round(6)
            if rect:
                ext_arr = idx.ids.exts_array()
                out_c = {"ids": ext_arr[safe[:, :k]].tolist(),
                         "scores": s_r[:, :k].tolist(),
                         "distances": d_r[:, :k].tolist()}
                if include_metadata:
                    out_c["metadata"] = [
                        [get_meta(r) or {} for r in rb]
                        for rb in rows_out[:, :k].tolist()]
                return out_c
            d_l, s_l, rows_l = d_r.tolist(), s_r.tolist(), rows_out.tolist()
            col_ids, col_s, col_d, col_m = [], [], [], []
            for b in range(B):
                rb, db, sb = rows_l[b], d_l[b], s_l[b]
                ids_b, s_b, d_b, m_b = [], [], [], []
                for j, r in enumerate(rb):
                    if 0 <= r < n_rows and \
                            (e := row_to_ext[r]) is not None:
                        ids_b.append(e)
                        s_b.append(sb[j])
                        d_b.append(db[j])
                        if include_metadata:
                            m_b.append(get_meta(r) or {})
                        if len(ids_b) == k:
                            break
                if include_metadata:
                    col_m.append(m_b)
                col_ids.append(ids_b)
                col_s.append(s_b)
                col_d.append(d_b)
            out_c = {"ids": col_ids, "scores": col_s, "distances": col_d}
            if include_metadata:
                out_c["metadata"] = col_m
            return out_c
        d_l, s_l, rows_l = d.tolist(), scores.tolist(), rows_out.tolist()
        out = []
        for b in range(B):
            rb, db, sb = rows_l[b], d_l[b], s_l[b]
            if include_metadata:
                hits = [{"id": e, "score": s, "distance": dd,
                         "metadata": get_meta(r) or {}}
                        for r, s, dd in zip(rb, sb, db)
                        if 0 <= r < n_rows
                        and (e := row_to_ext[r]) is not None]
            else:
                hits = [{"id": e, "score": s, "distance": dd}
                        for r, s, dd in zip(rb, sb, db)
                        if 0 <= r < n_rows
                        and (e := row_to_ext[r]) is not None]
            out.append(hits[:k])
        return out

    def search_graph(self, index: str, query, k: int = 10, *,
                     hydrate_depth: int = 1, **kw) -> list[list[dict]]:
        """VSearchGraph: search, then each hit's outgoing edges."""
        res = self.search(index, query, k, **kw)
        for hits in res:
            for hit in hits:
                nid = f"{index}/{hit['id']}"
                hit["edges"] = [
                    {"relation": rel, "target": e.target,
                     "weight": e.weight, "props": e.props}
                    for rel, e in self.graph.out_edges(nid)]
        return res

    # ------------------------------------------------------------- graph ops

    def link(self, index: str, source: str, relation: str, target: str, *,
             weight: float = 1.0, props: Optional[dict] = None,
             inverse: Optional[str] = None,
             created_at: Optional[float] = None) -> None:
        """VLink; node ids are namespaced index/node."""
        src, dst = f"{index}/{source}", f"{index}/{target}"
        now = created_at if created_at is not None else time.time()
        with self._lock:
            self.graph.add_edge(src, relation, dst, weight=weight,
                                props=props, created_at=now)
            if inverse:
                self.graph.add_edge(dst, inverse, src, weight=weight,
                                    props=props, created_at=now)
            self._dirty += 1
        self.events.emit(Event("edge.create", index, source,
                               {"relation": relation, "target": target}))

    def unlink(self, index: str, source: str, relation: str, target: str,
               deleted_at: Optional[float] = None) -> bool:
        src, dst = f"{index}/{source}", f"{index}/{target}"
        now = deleted_at if deleted_at is not None else time.time()
        with self._lock:
            ok = self.graph.remove_edge(src, relation, dst, deleted_at=now)
            self._dirty += 1
        if ok:
            self.events.emit(Event("edge.delete", index, source,
                                   {"relation": relation, "target": target}))
        return ok

    def get_edges(self, index: str, node: str,
                  relation: Optional[str] = None,
                  at_time: Optional[float] = None) -> list[dict]:
        return [{"relation": rel, "target": e.target.split("/", 1)[-1],
                 "weight": e.weight, "props": e.props,
                 "created_at": e.created_at}
                for rel, e in self.graph.out_edges(f"{index}/{node}",
                                                   relation, at_time)]

    def get_incoming_edges(self, index: str, node: str,
                           relation: Optional[str] = None,
                           at_time: Optional[float] = None) -> list[dict]:
        return [{"relation": rel, "source": r.source.split("/", 1)[-1],
                 "created_at": r.created_at}
                for rel, r in self.graph.in_edges(f"{index}/{node}",
                                                  relation, at_time)]

    def traverse(self, index: str, start: str, path: str, *,
                 at_time: Optional[float] = None,
                 include_metadata: bool = False) -> list[dict]:
        """VTraverse: dot-path N-hop walk, e.g. "knows.works_at"."""
        frontier = [f"{index}/{start}"]
        for rel in (p for p in path.split(".") if p):
            frontier = [e.target for node in frontier
                        for _, e in self.graph.out_edges(node, rel, at_time)]
        out = []
        h = self.indexes.get(index)
        for node in frontier:
            ext = node.split("/", 1)[-1]
            item = {"id": ext}
            if include_metadata and h is not None:
                row = h.index.ids.get(ext)
                if row is not None:
                    item["metadata"] = h.meta.get(row) or {}
            out.append(item)
        return out

    def extract_subgraph(self, index: str, root: str, depth: int = 2, *,
                         relation: Optional[str] = None,
                         at_time: Optional[float] = None,
                         guide_vector: Optional[Sequence[float]] = None,
                         guide_threshold: float = 0.0) -> dict[str, Any]:
        """VExtractSubgraph: BFS subgraph, optionally pruned by similarity
        to a guide vector."""
        h = self._handle(index)
        nodes = self.graph.bfs([f"{index}/{root}"],
                               min(depth, GRAPH_DEPTH_CLAMP),
                               relation=relation, at_time=at_time)
        keep = set(nodes)
        if guide_vector is not None and len(h.index) > 0:
            exts = [n.split("/", 1)[-1] for n in nodes]
            rows = [h.index.ids.get(e) for e in exts]
            valid = [(n, r) for n, r in zip(nodes, rows) if r is not None]
            if valid:
                q = np.asarray(guide_vector, np.float32)[None, :]
                allow = np.zeros(_cap_of(h.index), bool)
                allow[[r for _, r in valid]] = True
                d, rr = h.index.search(q, len(valid), allow_rows=allow)
                sims = fusion.minmax_normalize(
                    {int(r): float(dd) for dd, r in zip(d[0], rr[0])
                     if r >= 0}, invert=True)
                ok_rows = {r for r, s in sims.items()
                           if s >= guide_threshold}
                keep = {n for n, r in valid if r in ok_rows} | \
                    {f"{index}/{root}"}
        edges = []
        for n in keep:
            for rel, e in self.graph.out_edges(n, relation, at_time):
                if e.target in keep:
                    edges.append({"source": n.split("/", 1)[-1],
                                  "relation": rel,
                                  "target": e.target.split("/", 1)[-1],
                                  "weight": e.weight})
        return {"root": root,
                "nodes": sorted(n.split("/", 1)[-1] for n in keep),
                "edges": edges}

    def find_path(self, index: str, start: str, goal: str, *,
                  max_depth: int = 10, relation: Optional[str] = None,
                  at_time: Optional[float] = None) -> Optional[list[str]]:
        """FindPath: bidirectional BFS."""
        p = self.graph.find_path(f"{index}/{start}", f"{index}/{goal}",
                                 max_depth=max_depth, relation=relation,
                                 at_time=at_time)
        return None if p is None else [n.split("/", 1)[-1] for n in p]

    def evolve(self, index: str, old_id: str, new_id: str,
               vector: Sequence[float],
               metadata: Optional[dict] = None) -> None:
        """VEvolve: add the successor, link superseded_by / evolves_from,
        copy incoming edges, mark the old node historical."""
        h = self._handle(index)
        self.add(index, new_id, vector, metadata)
        self.link(index, old_id, "superseded_by", new_id)
        self.link(index, new_id, "evolves_from", old_id)
        for rel, r in list(self.graph.in_edges(f"{index}/{old_id}")):
            if rel in ("superseded_by", "evolves_from"):
                continue
            self.link(index, r.source.split("/", 1)[-1], rel, new_id)
        if self._row_of(h, old_id) is not None:
            self.update_metadata(index, old_id, {"_is_historical": True})
        self.events.emit(Event("memory.evolution", index, new_id,
                               {"from": old_id}))

    def evolution_chain(self, index: str, node: str,
                        max_len: int = 50) -> list[str]:
        """Walk evolves_from links back in time."""
        chain = [node]
        cur = node
        for _ in range(max_len):
            edges = self.get_edges(index, cur, relation="evolves_from")
            if not edges:
                break
            cur = edges[0]["target"]
            chain.append(cur)
        return chain

    # ------------------------------------------------------------------- KV

    def kv_set(self, key: str, value: bytes | str) -> None:
        with self._lock:
            self.kv.set(key, value)
            self._dirty += 1

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.kv.get(key)

    def kv_delete(self, key: str) -> bool:
        with self._lock:
            self._dirty += 1
            return self.kv.delete(key)

    def kv_scan(self, prefix: str = "") -> list[tuple[str, bytes]]:
        return list(self.kv.scan(prefix))

    # ------------------------------------------------------------ maintenance

    def stats(self) -> dict[str, Any]:
        return {
            "indexes": {n: self.index_info(n) for n in self.indexes},
            "kv_keys": len(self.kv),
            "graph_nodes": len(self.graph.out),
            "dirty_ops": self._dirty,
            "events_dropped": self.events.dropped,
        }

    def run_maintenance(self) -> dict[str, str]:
        """Per-index maintenance cycle."""
        out = {}
        with self._lock:
            for name, h in self.indexes.items():
                if hasattr(h.index, "run_maintenance_cycle"):
                    out[name] = h.index.run_maintenance_cycle()
        return out

    def _background(self) -> None:
        """Maintenance tick and graph vacuum."""
        last_maint = last_vacuum = time.time()
        while not self._stop.wait(1.0):
            now = time.time()
            try:
                if now - last_maint >= self.config.maintenance_interval:
                    last_maint = now
                    self.run_maintenance()
                if now - last_vacuum >= self.config.graph_vacuum_interval:
                    last_vacuum = now
                    with self._lock:
                        self.graph.vacuum(now - 30 * 24 * 3600)
            except Exception:   # pragma: no cover - keep the loop alive
                log.exception("background maintenance error")


class _LazyIndex:
    """Placeholder until the first vector fixes the dimension."""

    def __init__(self, metric: str, precision: str, cfg: HNSWConfig,
                 kind: str = "hnsw"):
        if precision == dist.BF16 and metric != dist.L2:
            raise ValueError("bfloat16 precision supports only euclidean")
        if precision == dist.INT8 and metric != dist.COSINE:
            raise ValueError("int8 precision supports only cosine")
        self.metric = metric
        self.precision = precision
        self.config = cfg
        self.kind = kind
        self.dim = 0
        self.deleted_count = 0
        self.ids = IDMap()

    def __len__(self):
        return 0

    def delete(self, ext_id: str) -> bool:
        return False


def _empty_hits(B: int, include_metadata: bool, columnar):
    """The result of a search over an empty index."""
    if not columnar:
        return [[] for _ in range(B)]
    out = {key: [[] for _ in range(B)]
           for key in ("ids", "scores", "distances")}
    if include_metadata:
        out["metadata"] = [[] for _ in range(B)]
    return out


def _cap_of(idx) -> int:
    return getattr(idx, "_cap", len(idx))
