"""Engine, in memory: the PyTorch port of kektordb_tpu/engine/engine.py.

Indexes, metadata, the knowledge graph and the KV store, behind one
readers-writer lock. A search settles pending writes under the exclusive
side, then runs the device search under the shared side, so concurrent
readers do not serialize.

Hybrid search (vector + BM25, `text_query` / `alpha`) and the
agent-memory time decay run through the device epilogue of ops/fuse.py
where the index serves from the scan (`search_device`), else through the
host path `_assemble_fused`, the same math in float64.

Persistence (`data_dir`), in the JAX package's on-disk formats: every
mutation is validated, then journaled to the AOF (persist/aof.py), then
applied in memory; `open` loads the newest checkpoint
(persist/checkpoint.py + index_io.py) and replays the journal after it;
`save_snapshot` writes a checkpoint and empties the journal (`close`,
`import_batch` and the background loop call it).

Not ported yet, and refused with NotImplementedError (ROADMAP.md, queue 1,
item numbers in the messages): sharded indexes (`shards > 1`) and
host-arena indexes (`kind="host"`). A journal or checkpoint written with
shards opens unsharded, as the JAX package opens it on a host with fewer
devices.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import asdict, dataclass
from typing import Any, Optional, Sequence

import numpy as np

from .. import device as devlib
from ..index.base import IDMap
from ..index.bruteforce import BruteForceIndex
from ..index.hnsw import (SERVE_MODES, HNSWConfig, HNSWIndex,
                          check_supported)
from ..ops import distance as dist
from ..ops import fuse as fuselib
from ..persist import aof as aoflib
from ..persist import checkpoint as ckptlib
from ..persist import index_io
from ..persist.resp import format_command, parse_command
from . import filters as filtlib
from . import fusion
from .events import Event, EventBus
from .graph import Edge, KnowledgeGraph, ReverseEdge
from .kv import KVStore
from .locks import RWLock
from .metadata import MetadataStore

log = logging.getLogger("kektordb")

GRAPH_DEPTH_CLAMP = 5  # resolveGraphFilter depth clamp (engine/graph.go:173)


@dataclass
class AutoLinkRule:
    """Auto-link on shared metadata value (hnsw/config.go:134,
    processAutoLinks ops.go:1699)."""
    field: str
    relation: str
    bidirectional: bool = False
    max_links: int = 32


@dataclass
class EngineConfig:
    device: str = "cuda"                    # raises if CUDA is absent
    data_dir: Optional[str] = None          # None -> in memory only
    snapshot_interval: float = 60.0         # engine.go:324 checkMaintenance
    snapshot_dirty_threshold: int = 1000
    maintenance_interval: float = 10.0      # maintenance tick
    graph_vacuum_interval: float = 3600.0   # hourly graph vacuum
    aof_rewrite_growth: float = 1.0         # rewrite at 100% growth
    aof_rewrite_min_bytes: int = 1 << 20    # min 1MB (engine.go:344-362)
    start_background: bool = True


class IndexHandle:
    """One named vector index + its metadata store + config."""

    def __init__(self, name: str, index, language: str = "english"):
        self.name = name
        self.index = index
        self.meta = MetadataStore(language)
        self.memory = fusion.MemoryConfig()
        self.auto_links: list[AutoLinkRule] = []
        self.language = language
        # allow-mask cache: (predicate/graph key + store versions) ->
        # (host mask, device mask). A cached device mask also skips the
        # [cap] host-to-device upload per request. Bounded LRU.
        self.mask_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.mask_hits = 0
        self.mask_misses = 0
        # device decay mirror: (key, MemoryConfig identity, DecayDevice).
        # Rebuilt when the decay columns mutate (DecayColumns.version) past
        # a few dirty rows, the memory config is replaced, cap grows, or
        # the f32 epoch ages out; otherwise refreshed in place from
        # DecayColumns.dirty. decay_lock serializes the refresh: searches
        # run under the SHARED side of the engine lock, and two refreshes
        # consuming one dirty set could lose each other's rows.
        self.decay_dev: Optional[tuple] = None
        self.decay_lock = threading.Lock()


class Engine:
    """open: load the checkpoint, open the lazy AOF, replay it, start the
    background loop (engine.Open, engine.go:162-239)."""

    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = devlib.resolve(self.config.device)
        self.indexes: dict[str, IndexHandle] = {}
        self.kv = KVStore()
        self.graph = KnowledgeGraph()
        self.events = EventBus()
        # `with self._lock` = exclusive write side; searches take
        # `self._lock.read()`
        self._lock = RWLock()
        self._aof: Optional[aoflib.LazyAOFWriter] = None
        self._dirty = 0
        self._last_snapshot = time.time()
        self._aof_base_size = 0
        self._stop = threading.Event()
        self._bg: Optional[threading.Thread] = None
        self._opened = False

    # ------------------------------------------------------------------ open

    def open(self) -> "Engine":
        with self._lock:
            if self._opened:
                return self
            if self.config.data_dir:
                os.makedirs(self.config.data_dir, exist_ok=True)
                self._load_checkpoint()
                self._aof = aoflib.LazyAOFWriter(self._aof_path())
                try:
                    self._replay_aof()
                except BaseException:
                    self._aof.close()
                    self._aof = None
                    raise
                self._aof_base_size = self._aof.size()
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
            try:
                self.save_snapshot()
            finally:
                if self._aof:
                    self._aof.close()
                    self._aof = None
                self._opened = False

    def _aof_path(self) -> str:
        return os.path.join(self.config.data_dir, "journal.aof")

    def _ckpt_root(self) -> str:
        return os.path.join(self.config.data_dir, "checkpoints")

    # -------------------------------------------------------------- journal

    def _journal(self, *parts: bytes | str) -> None:
        """AOF-before-RAM (ops.go:349-364): every mutation is framed and
        handed to the lazy writer before the in-memory apply."""
        if self._aof is not None:
            self._aof.write(format_command(*parts))
        self._dirty += 1

    # -------------------------------------------------------- index mgmt

    def create_index(self, name: str, *, metric: str = dist.L2,
                     precision: str = dist.F32, m: int = 16,
                     ef_construction: int = 200, ef_search: int = 100,
                     language: str = "english", kind: str = "hnsw",
                     seed: int = 42, shards: int = 0,
                     serve_mode: str = "auto",
                     serve_proj_dim: Optional[int] = None,
                     serve_proj_rerank: int = 128,
                     _journal: bool = True) -> None:
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
                             serve_proj_dim=serve_proj_dim or 0,
                             serve_proj_rerank=serve_proj_rerank)
            if kind == "hnsw":
                check_supported(cfg)
            # the dimension is fixed by the first add
            lazy = _LazyIndex(metric, precision, cfg, kind=kind)
            if _journal:
                self._journal("VCREATE", name, metric, precision,
                              json.dumps({"m": m,
                                          "ef_construction": ef_construction,
                                          "ef_search": ef_search,
                                          "language": language,
                                          "seed": seed,
                                          "kind": kind,
                                          "shards": shards,
                                          "serve_mode": serve_mode,
                                          "serve_proj_dim": serve_proj_dim,
                                          "serve_proj_rerank":
                                              serve_proj_rerank}))
            self.indexes[name] = IndexHandle(name, lazy, language=language)

    def drop_index(self, name: str, _journal: bool = True) -> None:
        with self._lock:
            if name not in self.indexes:
                raise KeyError(f"no such index: {name}")
            if _journal:
                self._journal("VDROP", name)
            del self.indexes[name]

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

    def configure_index(self, name: str, config: dict[str, Any],
                        _journal: bool = True) -> None:
        """VCONFIG: runtime settings of an index: memory / decay, auto-link
        rules, and the index knobs ef_search, scan_exact, scan_precision,
        int8_symmetric, serve_mode, max_unlinked, serve_proj_dim and
        serve_proj_rerank. Changing serve_proj_dim drops the projection's
        basis and arena (derived data, refit at the next search)."""
        h = self._handle(name)
        with self._lock:
            icfg = getattr(h.index, "config", None)
            if icfg is not None:
                if config.get("scan_precision", "high") not in ("high",
                                                                "fast"):
                    raise ValueError("scan_precision must be high|fast")
                if config.get("serve_mode", "auto") not in SERVE_MODES:
                    raise ValueError("serve_mode must be auto|scan|beam")
            if _journal:
                self._journal("VCONFIG", name, json.dumps(config))
            mem = config.get("memory")
            if mem:
                layers = {k: fusion.LayerConfig(**v)
                          for k, v in (mem.get("layers") or {}).items()}
                h.memory = fusion.MemoryConfig(
                    enabled=bool(mem.get("enabled", True)),
                    decay_half_life=float(
                        mem.get("decay_half_life",
                                h.memory.decay_half_life)),
                    decay_model=mem.get("decay_model", h.memory.decay_model),
                    layers=layers)
            if "auto_links" in config:
                h.auto_links = [AutoLinkRule(**r)
                                for r in config["auto_links"]]
            if icfg is None:
                return
            if "ef_search" in config:
                icfg.ef_search = int(config["ef_search"])
            if "scan_exact" in config:
                icfg.scan_exact = bool(config["scan_exact"])
            if "scan_precision" in config:
                icfg.scan_precision = config["scan_precision"]
            if "int8_symmetric" in config:
                icfg.int8_symmetric = bool(config["int8_symmetric"])
            if "serve_mode" in config:
                icfg.serve_mode = config["serve_mode"]
            if "max_unlinked" in config:
                icfg.max_unlinked = max(0, int(config["max_unlinked"]))
            if "serve_proj_dim" in config:
                icfg.serve_proj_dim = max(0, int(config["serve_proj_dim"]))
                if isinstance(h.index, HNSWIndex):
                    h.index.invalidate_projection()
            if "serve_proj_rerank" in config:
                icfg.serve_proj_rerank = max(
                    1, int(config["serve_proj_rerank"]))

    def _handle(self, name: str) -> IndexHandle:
        h = self.indexes.get(name)
        if h is None:
            raise KeyError(f"no such index: {name}")
        return h

    # ----------------------------------------------------------- write path

    def add(self, index: str, ext_id: str, vector: Sequence[float],
            metadata: Optional[dict[str, Any]] = None,
            _journal: bool = True) -> None:
        """VADD (ops.go:268): validate -> journal -> index insert ->
        metadata -> auto-links -> event."""
        h = self._handle(index)
        vec = np.asarray(vector, np.float32).reshape(-1)
        meta = dict(metadata or {})
        with self._lock:
            self._ensure_materialized(h, vec.shape[-1])
            # validated before the journal, so a rejected op never lands
            # in the AOF
            self._validate_add(h, [ext_id], vec[None, :])
            self._stamp_memory(h, meta)
            if _journal:
                self._journal("VADD", index, ext_id, vec.tobytes(),
                              json.dumps(meta) if meta else "")
            h.index.add(ext_id, vec)
            if meta:
                row = self._row_of(h, ext_id)
                if row is not None:
                    h.meta.set(row, meta)
            self._process_auto_links(h, ext_id, meta)
        self.events.emit(Event("vector.add", index, ext_id))

    def add_batch(self, index: str, ext_ids: Sequence[str],
                  vectors: np.ndarray,
                  metadatas: Optional[Sequence[Optional[dict]]] = None,
                  fast: bool = False, _journal: bool = True) -> None:
        """VAddBatch (ops.go:1384): one journal frame per vector first,
        then the bulk device build, then per-item metadata."""
        h = self._handle(index)
        vectors = np.asarray(vectors, np.float32)
        metas = [dict(m or {}) for m in
                 (metadatas if metadatas else [None] * len(ext_ids))]
        with self._lock:
            if len(ext_ids):
                self._ensure_materialized(h, vectors.shape[-1])
                self._validate_add(h, ext_ids, vectors)
            for j, (e, m) in enumerate(zip(ext_ids, metas)):
                self._stamp_memory(h, m)
                if _journal:
                    self._journal("VADD", index, e, vectors[j].tobytes(),
                                  json.dumps(m) if m else "")
            h.index.add_batch(ext_ids, vectors, fast=fast)
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
        """VImport (ops.go:1503): bypasses the journal; a fast graph build,
        a full refine, then a forced snapshot."""
        h = self._handle(index)
        self.add_batch(index, ext_ids, vectors, metadatas, fast=True,
                       _journal=False)
        with self._lock:
            if hasattr(h.index, "turbo_refine"):
                h.index.turbo_refine()
        if self.config.data_dir:
            self.save_snapshot()

    def delete(self, index: str, ext_id: str, _journal: bool = True) -> bool:
        """VDEL: soft delete + metadata and graph-node removal."""
        h = self._handle(index)
        with self._lock:
            row = self._row_of(h, ext_id)
            if _journal:
                self._journal("VDEL", index, ext_id)
            ok = h.index.delete(ext_id)
            if ok and row is not None:
                h.meta.remove(row)
                self.graph.drop_node(f"{index}/{ext_id}")
        if ok:
            self.events.emit(Event("vector.delete", index, ext_id))
        return ok

    def update_metadata(self, index: str, ext_id: str,
                        patch: dict[str, Any], _journal: bool = True) -> None:
        """VMETA: merge a metadata patch."""
        h = self._handle(index)
        with self._lock:
            row = self._row_of(h, ext_id)
            if row is None:
                raise KeyError(f"no such id: {ext_id}")
            if _journal:
                self._journal("VMETA", index, ext_id, json.dumps(patch))
            h.meta.update(row, patch)
        self.events.emit(Event("vector.update", index, ext_id))

    def get(self, index: str, ext_id: str) -> dict[str, Any]:
        h = self._handle(index)
        row = self._row_of(h, ext_id)
        if row is None:
            raise KeyError(f"no such id: {ext_id}")
        return {"id": ext_id, "metadata": h.meta.get(row) or {}}

    def reinforce(self, index: str, ext_id: str,
                  _journal: bool = True) -> None:
        """VReinforce (ops.go:697): bump _last_accessed / _access_count.
        The decay columns mark the row dirty, so the next decayed search
        refreshes the device mirror in place."""
        h = self._handle(index)
        with self._lock:
            row = self._row_of(h, ext_id)
            if row is None:
                raise KeyError(f"no such id: {ext_id}")
            meta = h.meta.get(row) or {}
            patch = {
                fusion.ACCESSED_KEY: time.time(),
                fusion.ACCESS_COUNT_KEY:
                    int(meta.get(fusion.ACCESS_COUNT_KEY) or 0) + 1,
            }
            if _journal:
                self._journal("VMETA", index, ext_id, json.dumps(patch))
            h.meta.update(row, patch)
        self.events.emit(Event("vector.access", index, ext_id))

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

    def _process_auto_links(self, h: IndexHandle, ext_id: str,
                            meta: dict[str, Any]) -> None:
        """processAutoLinks (ops.go:1699): link nodes sharing a field
        value. Runs on `add`, as in the reference (not on `add_batch`)."""
        for rule in h.auto_links:
            val = meta.get(rule.field)
            if val is None:
                continue
            sval = val if isinstance(val, str) else str(val)
            rows = h.meta.inverted.get(rule.field, {}).get(sval, set())
            linked = 0
            for row in rows:
                other = h.index.ids.row_to_ext[row] \
                    if row < len(h.index.ids.row_to_ext) else None
                if other is None or other == ext_id:
                    continue
                self.link(h.name, ext_id, rule.relation, other,
                          _journal=True)
                if rule.bidirectional:
                    self.link(h.name, other, rule.relation, ext_id,
                              _journal=True)
                linked += 1
                if linked >= rule.max_links:
                    break

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
        """searchWithFusion (ops.go:896-1208): filter -> allow rows; graph
        BFS -> intersect; vector + BM25 (`text_query`, weight `alpha` on
        the vector side); min-max normalized scores; time decay on a
        memory-enabled index (unless decay=False); top-k. Accepts [D] or
        [B, D]; returns a list of per-query hit lists, or with
        columnar=True {"ids", "scores", "distances"[, "metadata"]} ([B][<=k]
        lists; columnar="np" keeps scores and distances as [B, k] float32
        arrays when every hit resolves)."""
        h = self._handle(index)
        q = np.atleast_2d(np.asarray(query, np.float32))
        B = q.shape[0]
        idx = h.index
        if idx.dim and q.shape[-1] != idx.dim:
            raise ValueError(
                f"query dim {q.shape[-1]} != index dim {idx.dim}")
        kwargs = dict(ef=ef, filter=filter, text_query=text_query,
                      alpha=alpha, graph_root=graph_root,
                      graph_depth=graph_depth, graph_relation=graph_relation,
                      at_time=at_time, include_metadata=include_metadata,
                      decay=decay, index=index, columnar=columnar)
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

    def _search_locked(self, h, idx, q, B, k, *, ef, filter, text_query,
                       alpha, graph_root, graph_depth, graph_relation,
                       at_time, include_metadata, decay, index,
                       columnar=False):
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

        text_rows = np.empty(0, np.int64)
        text_vals = np.empty(0, np.float64)
        if text_query:
            text_rows, text_vals = h.meta.text.search_arrays(text_query)
            if text_rows.size:
                m = text_rows < cap
                if allow is not None:
                    m[m] = allow[text_rows[m]]
                if not m.all():
                    text_rows, text_vals = text_rows[m], text_vals[m]

        text_only = text_query and _is_zero(q)
        decay_on = decay and h.memory.enabled
        if not text_only and len(idx) > 0:
            fetch = max(k, (ef or 0))
            if text_query or decay_on:
                fetch = max(fetch, 2 * k)  # headroom for re-ranking
            allow_arg = allow_dev if allow_dev is not None else allow
            if text_rows.size or decay_on:
                # device epilogue: fusion + decay + top-k chained onto the
                # scan's device tensors, one copy back (ops/fuse.py); the
                # host path below is the same math
                sd = getattr(idx, "search_device", None)
                res = sd(q, fetch, allow_rows=allow_arg) \
                    if sd is not None else None
                if res is not None:
                    d_dev, rows_dev, scale = res
                    sc, rw, dd = fuselib.fused_topk(
                        d_dev, rows_dev, text_rows, text_vals,
                        alpha if text_rows.size else 1.0, k,
                        scale, cap_t=max(self.TEXT_CAND_CAP, 4 * k),
                        decay_dev=self._decay_device(h, cap)
                        if decay_on else None)
                    return self._emit_topk(h, idx, sc, rw, dd, B, k,
                                           include_metadata, columnar)
            d, rows_out = idx.search(q, fetch, ef=ef, allow_rows=allow_arg)
            d = np.asarray(d, np.float32)
            rows_out = np.asarray(rows_out, np.int64)
            if text_rows.size == 0 and not decay_on:
                return self._assemble_fast(h, idx, d, rows_out, B, k,
                                           include_metadata,
                                           columnar=columnar)
        else:
            d = np.zeros((B, 0), np.float32)
            rows_out = np.zeros((B, 0), np.int64)
        return self._assemble_fused(
            h, idx, d, rows_out, B, k, text_rows=text_rows,
            text_vals=text_vals, alpha=alpha, decay=decay,
            include_metadata=include_metadata, columnar=columnar)

    # cap on text-branch candidates folded into the fusion (BM25 can match
    # thousands of rows; beyond the top few hundred they cannot reach the
    # fused top-k at any alpha)
    TEXT_CAND_CAP = 512

    # refresh the decay mirror's f32 epoch after this many seconds: at a
    # 12h offset f32 still resolves ~5 ms, far below any decay half-life
    DECAY_EPOCH_MAX_AGE = 12 * 3600.0

    def _decay_device(self, h, cap: int):
        """Version-keyed device mirror of the per-row decay spec
        (ops/fuse.py build_decay_device); None only for cap = 0."""
        if cap <= 0:
            return None
        cols = h.meta.decay
        key = (cols.version, cap)

        def fresh(ent, same_key=True):
            return ent is not None and ent[1] is h.memory \
                and (ent[0] == key if same_key else ent[0][1] == cap) \
                and time.time() - ent[2].epoch < self.DECAY_EPOCH_MAX_AGE
        ent = h.decay_dev
        if fresh(ent):
            return ent[2]
        with h.decay_lock:
            ent = h.decay_dev            # may have refreshed while waiting
            if fresh(ent):
                return ent[2]
            # reinforce-on-read (the mcp_memory pattern) bumps the version
            # per hit: when the stale mirror differs in a few dirty rows,
            # refresh those in place instead of rebuilding O(cap)
            if fresh(ent, same_key=False) \
                    and 0 < len(cols.dirty) <= max(256, cap // 64):
                dd = fuselib.update_decay_device(ent[2], cols, h.memory,
                                                 cols.dirty)
            else:
                dd = fuselib.build_decay_device(cols, h.memory, cap,
                                                self.device)
            cols.dirty.clear()
            h.decay_dev = (key, h.memory, dd)
        return dd

    def _assemble_fused(self, h, idx, d: np.ndarray, rows_out: np.ndarray,
                        B: int, k: int, *, text_rows: np.ndarray,
                        text_vals: np.ndarray,
                        alpha: float, decay: bool, include_metadata: bool,
                        columnar: bool = False, now: Optional[float] = None):
        """Host fusion + decay assembly in float64 (ops.go:1071-1186
        semantics: min-max normalize both branches, alpha-fuse over the
        union, decay at `now` (default the clock), top-k): arrays end to
        end, per-hit dicts only for the final k."""
        F = rows_out.shape[1]
        valid = rows_out >= 0
        if F == 0:
            vec_sim = np.zeros((B, 0), np.float64)
        else:
            dm = np.where(valid, d, np.nan)
            all_nan = ~valid.any(axis=1, keepdims=True)
            with np.errstate(invalid="ignore"):
                lo = np.nanmin(np.where(all_nan, 0.0, dm), axis=1,
                               keepdims=True)
                hi = np.nanmax(np.where(all_nan, 0.0, dm), axis=1,
                               keepdims=True)
            span = hi - lo
            ok_span = span > 0
            vec_sim = np.where(ok_span,
                               (hi - d) / np.where(ok_span, span, 1.0),
                               1.0).astype(np.float64)
            vec_sim = np.where(valid, vec_sim, -np.inf)

        if text_rows.size:
            cap_t = max(self.TEXT_CAND_CAP, 4 * k)
            if text_rows.size > cap_t:
                sel = np.argpartition(text_vals, text_vals.size - cap_t
                                      )[-cap_t:]
                tr, ts = text_rows[sel], text_vals[sel]
            else:
                tr, ts = text_rows, text_vals
            t_lo, t_hi = ts.min(), ts.max()
            tsn = np.ones_like(ts) if t_hi <= t_lo \
                else (ts - t_lo) / (t_hi - t_lo)
            order = np.argsort(tr, kind="stable")
            tr, tsn = tr[order], tsn[order]
            T = tr.size
            # text score for every vector candidate (sorted lookup)
            pos = np.searchsorted(tr, np.where(valid, rows_out, 0))
            pos = np.minimum(pos, T - 1)
            tmatch = valid & (tr[pos] == rows_out)
            text_of_vec = np.where(tmatch, tsn[pos], 0.0)
            # appended text-only candidates; a scatter over tmatch marks
            # the rows already among the query's vector candidates
            dup = np.zeros((B, T), bool)
            bidx, fidx = np.nonzero(tmatch)
            dup[bidx, pos[bidx, fidx]] = True
            R_all = np.concatenate(
                [rows_out, np.broadcast_to(tr, (B, T))], axis=1)
            vec_all = np.concatenate(
                [np.where(valid, vec_sim, 0.0), np.zeros((B, T))], axis=1)
            text_all = np.concatenate(
                [text_of_vec, np.broadcast_to(tsn, (B, T))], axis=1)
            fused = alpha * vec_all + (1.0 - alpha) * text_all
            fused[:, :F] = np.where(valid, fused[:, :F], -np.inf)
            fused[:, F:] = np.where(dup, -np.inf, fused[:, F:])
        else:
            R_all = rows_out
            fused = vec_sim

        if decay and h.memory.enabled:
            factors = fusion.decay_factors(
                h.meta.decay, R_all, h.memory,
                time.time() if now is None else now)
            with np.errstate(invalid="ignore"):     # -inf * factor
                fused = np.where(np.isfinite(fused), fused * factors, fused)

        kk = min(k, fused.shape[1]) if fused.shape[1] else 0
        if kk == 0:
            return _empty_hits(B, include_metadata, columnar)
        part = np.argpartition(-fused, kk - 1, axis=1)[:, :kk]
        psc = np.take_along_axis(fused, part, axis=1)
        order = np.argsort(-psc, axis=1, kind="stable")
        top = np.take_along_axis(part, order, axis=1)
        top_sc = np.take_along_axis(psc, order, axis=1)
        top_rows = np.take_along_axis(R_all, top, axis=1)
        # a hit's distance: its vector candidate's, inf for a text-only hit
        top_d = np.full(top.shape, np.inf)
        from_vec = top < F
        if F:
            cand_d = np.take_along_axis(d, np.minimum(top, F - 1), axis=1)
            cand_ok = np.take_along_axis(valid, np.minimum(top, F - 1),
                                         axis=1)
            top_d = np.where(from_vec & cand_ok, cand_d, np.inf)
        # the host path answers in lists even for columnar="np", as the
        # reference's does
        return self._emit_topk(h, idx, top_sc, top_rows, top_d, B, k,
                               include_metadata, bool(columnar))

    def _emit_topk(self, h, idx, top_sc: np.ndarray, top_rows: np.ndarray,
                   top_d: np.ndarray, B: int, k: int,
                   include_metadata: bool, columnar: bool = False):
        """Final hits from fused top-k arrays (device or host path): hits
        with a -inf score or a row without an id are skipped; top_d is inf
        for a text-only hit, whose distance is then omitted (None in the
        columnar form)."""
        kk = top_sc.shape[1]
        fin = np.isfinite(top_sc)
        row_to_ext = idx.ids.row_to_ext
        n_rows = len(row_to_ext)
        get_meta = h.meta.get
        if columnar:
            safe = np.clip(top_rows, 0, max(n_rows - 1, 0))
            live = idx.ids.live_mask(max(n_rows, 1))
            ok = fin & (top_rows >= 0) & (top_rows < n_rows) & live[safe]
            if kk >= k and columnar == "np" and not include_metadata \
                    and bool(ok[:, :k].all()):
                ext_arr = idx.ids.exts_array()
                return {"ids": ext_arr[safe[:, :k]].tolist(),
                        "scores": np.ascontiguousarray(
                            top_sc[:, :k], np.float32),
                        "distances": np.ascontiguousarray(
                            top_d[:, :k], np.float32)}
            sc_l = top_sc.astype(np.float64).round(6).tolist()
            d_l = top_d.astype(np.float64).round(5).tolist()
        else:
            sc_l = top_sc.tolist()
            d_l = top_d.tolist()
        fin_l = fin.tolist()
        find_l = np.isfinite(top_d).tolist()
        rows_l = top_rows.tolist()
        col_ids, col_s, col_d, col_m = [], [], [], []
        for b in range(B):
            rb, sb, db = rows_l[b], sc_l[b], d_l[b]
            fb, fdb = fin_l[b], find_l[b]
            ids_b, s_b, d_b, m_b = [], [], [], []
            for j, r in enumerate(rb):
                if not fb[j] or not 0 <= r < n_rows:
                    continue
                ext = row_to_ext[r]
                if ext is None:
                    continue
                ids_b.append(ext)
                s_b.append(sb[j])
                d_b.append(db[j] if fdb[j] else None)
                if include_metadata:
                    m_b.append(get_meta(r) or {})
            col_ids.append(ids_b)
            col_s.append(s_b)
            col_d.append(d_b)
            col_m.append(m_b)
        if columnar:
            out_c = {"ids": col_ids, "scores": col_s, "distances": col_d}
            if include_metadata:
                out_c["metadata"] = col_m
            return out_c
        out = []
        for ids_b, s_b, d_b, m_b in zip(col_ids, col_s, col_d, col_m):
            hits = []
            for j, e in enumerate(ids_b):
                hit = {"id": e, "score": s_b[j]}
                if d_b[j] is not None:
                    hit["distance"] = d_b[j]
                if include_metadata:
                    hit["metadata"] = m_b[j]
                hits.append(hit)
            out.append(hits)
        return out

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
             inverse: Optional[str] = None, _journal: bool = True,
             created_at: Optional[float] = None) -> None:
        """VLink (GLINK); node ids are namespaced index/node."""
        src, dst = f"{index}/{source}", f"{index}/{target}"
        now = created_at if created_at is not None else time.time()
        with self._lock:
            if _journal:
                self._journal("GLINK", src, relation, dst, str(weight),
                              json.dumps(props or {}), str(now))
            self.graph.add_edge(src, relation, dst, weight=weight,
                                props=props, created_at=now)
            if inverse:
                if _journal:
                    self._journal("GLINK", dst, inverse, src, str(weight),
                                  json.dumps(props or {}), str(now))
                self.graph.add_edge(dst, inverse, src, weight=weight,
                                    props=props, created_at=now)
        self.events.emit(Event("edge.create", index, source,
                               {"relation": relation, "target": target}))

    def unlink(self, index: str, source: str, relation: str, target: str,
               _journal: bool = True,
               deleted_at: Optional[float] = None) -> bool:
        """GUNLINK."""
        src, dst = f"{index}/{source}", f"{index}/{target}"
        now = deleted_at if deleted_at is not None else time.time()
        with self._lock:
            if _journal:
                self._journal("GUNLINK", src, relation, dst, str(now))
            ok = self.graph.remove_edge(src, relation, dst, deleted_at=now)
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

    def belief_state(self, index: str, node_id: str, *, k: int = 10,
                     language: Optional[str] = None):
        """VBeliefState (epistemic.go:22); see engine/epistemic.py."""
        from . import epistemic
        h = self._handle(index)
        return epistemic.assess(self, index, node_id, k=k,
                                language=language or h.language)

    # ------------------------------------------------------------------- KV

    def kv_set(self, key: str, value: bytes | str,
               _journal: bool = True) -> None:
        with self._lock:
            if _journal:
                self._journal("SET", key,
                              value if isinstance(value, (bytes, bytearray))
                              else value.encode())
            self.kv.set(key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.kv.get(key)

    def kv_delete(self, key: str, _journal: bool = True) -> bool:
        with self._lock:
            if _journal:
                self._journal("DEL", key)
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
        """engine.go:277-320: the snapshot check (dirty ops or age), the
        AOF rewrite (a snapshot, once the journal has grown by
        aof_rewrite_growth past its size after the last one), the
        maintenance tick and the graph vacuum. The AOF's own thread
        flushes it."""
        last_maint = last_vacuum = time.time()
        while not self._stop.wait(1.0):
            now = time.time()
            try:
                if self.config.data_dir and self._dirty and (
                        self._dirty >= self.config.snapshot_dirty_threshold
                        or now - self._last_snapshot
                        >= self.config.snapshot_interval):
                    self.save_snapshot()
                if self._aof is not None:
                    size = self._aof.size()
                    if (size > self.config.aof_rewrite_min_bytes
                            and size > self._aof_base_size
                            * (1 + self.config.aof_rewrite_growth)):
                        self.save_snapshot()   # truncates the journal
                if now - last_maint >= self.config.maintenance_interval:
                    last_maint = now
                    self.run_maintenance()
                if now - last_vacuum >= self.config.graph_vacuum_interval:
                    last_vacuum = now
                    with self._lock:
                        self.graph.vacuum(now - 30 * 24 * 3600)
            except Exception:   # pragma: no cover - keep the loop alive
                log.exception("background maintenance error")

    # --------------------------------------------------------- checkpointing

    def save_snapshot(self) -> Optional[str]:
        """SaveSnapshot (recovery.go:459-558): divert journal writes to the
        shadow buffer, write the checkpoint, truncate the journal, then
        append the shadow's frames. Returns the generation's path. An
        engine that has not opened its data dir writes nothing: it would
        checkpoint an empty state over the data on disk."""
        if not self.config.data_dir or not self._opened:
            return None
        with self._lock:
            if self._aof:
                self._aof.begin_snapshot_mode()
            try:
                arrays, state = self._snapshot_state()
                path = ckptlib.save(self._ckpt_root(), arrays, state)
                if self._aof:
                    self._aof.truncate()
            finally:
                if self._aof:
                    self._aof.write_raw_frames(self._aof.end_snapshot_mode())
            self._dirty = 0
            self._last_snapshot = time.time()
            self._aof_base_size = self._aof.size() if self._aof else 0
        return path

    def _snapshot_state(self) -> tuple[dict, dict]:
        arrays: dict[str, Any] = {}
        state: dict[str, Any] = {
            "version": 1,
            "kv": self.kv.items(),
            "graph": _graph_to_state(self.graph),
            "indexes": {},
        }
        for name, h in self.indexes.items():
            idx = h.index
            common = {"language": h.language,
                      "memory": _memory_to_state(h.memory),
                      "auto_links": [asdict(r) for r in h.auto_links]}
            if isinstance(idx, _LazyIndex):
                state["indexes"][name] = {
                    "lazy": True, "metric": idx.metric,
                    "precision": idx.precision,
                    "config": asdict(idx.config),
                    "kind": idx.kind, "shards": 0, **common}
                continue
            st = index_io.dump_index(idx, name, arrays)
            st.update({"lazy": False, **common,
                       "metadata": {int(r): m
                                    for r, m in h.meta.direct.items()}})
            state["indexes"][name] = st
        return arrays, state

    def _load_checkpoint(self) -> None:
        loaded = ckptlib.load(self._ckpt_root())
        if loaded is None:
            return
        arrays, state = loaded
        for k, v in (state.get("kv") or {}).items():
            self.kv.set(k, v)
        _graph_from_state(self.graph, state.get("graph") or {})
        for name, st in (state.get("indexes") or {}).items():
            if st.get("lazy"):
                kind = st.get("kind", "hnsw")
                if kind == "host":
                    raise NotImplementedError(
                        f"checkpoint index {name!r} is of kind 'host' "
                        "(index/hostarena), which is not ported yet "
                        "(ROADMAP.md, queue 1, item 10)")
                if int(st.get("shards", 0)) > 1:
                    log.warning("checkpoint: index %s was created with "
                                "shards=%s; it opens unsharded", name,
                                st["shards"])
                cfg = index_io.cfg_from(st) if "config" in st \
                    else HNSWConfig()
                h = IndexHandle(name, _LazyIndex(st["metric"],
                                                 st["precision"], cfg,
                                                 kind=kind),
                                language=st.get("language", "english"))
            else:
                h = IndexHandle(name, index_io.load_index(
                    st, arrays, name, device=self.device),
                    language=st.get("language", "english"))
                metas = st.get("metadata") or {}
                if metas and st.get("kind") == "sharded":
                    # keyed by the sharded index's global rows; the merged
                    # index numbered its rows anew
                    ext = {g: e for e, g in st["ext_to_gid"].items()}
                    metas = {h.index.ids.get(ext.get(int(g))): m
                             for g, m in metas.items()}
                    metas.pop(None, None)
                if metas:
                    h.meta.set_batch([int(r) for r in metas],
                                     list(metas.values()))
            h.memory = _memory_from_state(st.get("memory") or {})
            h.auto_links = [AutoLinkRule(**r)
                            for r in st.get("auto_links") or []]
            self.indexes[name] = h

    # --------------------------------------------------------------- replay

    def _replay_aof(self) -> None:
        """replayAOF (recovery.go:78-457): read every frame, compact in
        memory (a later op on a key overwrites an earlier one), then apply
        in bulk: KV, then per index its creation, adds (one add_batch),
        metadata, deletes, metadata patches of older rows and its last
        VCONFIG, then the graph's links in journal order."""
        corrupt: list[int] = []
        kv_data: dict[str, Optional[bytes]] = {}
        idx_ops: dict[str, dict[str, Any]] = {}
        order: list[tuple] = []
        for _, payload in aoflib.read_frames(self._aof_path(),
                                             on_corruption=corrupt.append):
            try:
                parts = parse_command(payload)
            except ValueError:
                continue
            if not parts:
                continue
            cmd = parts[0].decode().upper()
            try:
                _compact_one(cmd, parts, kv_data, idx_ops, order)
            except (ValueError, IndexError, TypeError):
                log.warning("skipping bad AOF command %s", cmd)
        if corrupt:
            log.warning("AOF resync: %d corrupt region(s) skipped",
                        len(corrupt))
        for k, v in kv_data.items():
            if v is None:
                self.kv.delete(k)
            else:
                self.kv.set(k, v)
        for name, ops in idx_ops.items():
            if ops.get("dropped"):
                self.indexes.pop(name, None)
                continue
            if name not in self.indexes and ops.get("create"):
                self._replay_create(name, ops["create"])
            if name not in self.indexes:
                continue
            self._replay_entries(name, ops)
        for op in order:
            if op[0] == "GLINK":
                _, src, rel, dst, w, props, ts = op
                self.graph.add_edge(src, rel, dst, weight=w, props=props,
                                    created_at=ts)
            else:
                _, src, rel, dst, ts = op
                self.graph.remove_edge(src, rel, dst, deleted_at=ts)

    def _replay_create(self, name: str, c: dict[str, Any]) -> None:
        # a journal written by a newer build may carry config keys this
        # one does not know: drop them with a warning
        known = set(inspect.signature(self.create_index).parameters)
        unknown = set(c) - known
        if unknown:
            log.warning("AOF replay: ignoring unknown index config keys "
                        "%s for %s", sorted(unknown), name)
            c = {k: v for k, v in c.items() if k in known}
        if int(c.get("shards", 0)) > 1:
            # journaled with shards: recreated unsharded so the database
            # opens (the journal carries the raw vectors, so no data is
            # lost), as the JAX package does on a smaller mesh
            log.warning("AOF replay: index %s journaled with shards=%s; "
                        "recreating it unsharded", name, c["shards"])
            c = dict(c, shards=0)
        self.create_index(name, _journal=False, **c)

    def _replay_entries(self, name: str, ops: dict[str, Any]) -> None:
        entries = ops.get("entries") or {}
        alive = {e: v for e, v in entries.items() if v is not None}
        h = self.indexes[name]
        todo = {e: v for e, v in alive.items() if self._row_of(h, e) is None}
        if todo:
            # per-entry shape tolerance: a wrong-dim frame must not stop
            # the database from opening
            bufs = {e: np.frombuffer(v[0], np.float32)
                    for e, v in todo.items()}
            dim = h.index.dim or Counter(
                v.size for v in bufs.values()).most_common(1)[0][0]
            ids = [e for e in todo if bufs[e].size == dim]
            if len(ids) < len(todo):
                log.warning("AOF replay: skipping %d wrong-dim entries in %s",
                            len(todo) - len(ids), name)
            if ids:
                try:
                    self.add_batch(name, ids,
                                   np.stack([bufs[e] for e in ids]),
                                   [todo[e][1] for e in ids],
                                   _journal=False)
                except Exception:
                    log.exception("AOF replay: bulk apply failed for %s",
                                  name)
        for e, v in alive.items():
            if v[1] and e not in todo:
                row = self._row_of(h, e)
                if row is not None:
                    h.meta.update(row, v[1])
        for e, v in entries.items():
            if v is None:
                self.delete(name, e, _journal=False)
        # VMETA patches of rows that predate this journal
        for e, patch in ops.get("meta_patches") or []:
            row = self._row_of(h, e)
            if row is not None:
                h.meta.update(row, patch)
        if ops.get("config"):
            self.configure_index(name, ops["config"], _journal=False)


def _compact_one(cmd: str, parts: list[bytes], kv_data, idx_ops,
                 order) -> None:
    """Fold one journaled command into the replay's compacted state."""
    def dec(i):
        return parts[i].decode()

    if cmd == "SET":
        kv_data[dec(1)] = parts[2]
    elif cmd == "DEL":
        kv_data[dec(1)] = None
    elif cmd == "VCREATE":
        # VCREATE name metric precision config_json
        cfg = json.loads(dec(4)) if len(parts) > 4 and parts[4] else {}
        idx_ops.setdefault(dec(1), {})["create"] = dict(
            metric=dec(2), precision=dec(3), **cfg)
    elif cmd == "VDROP":
        idx_ops.setdefault(dec(1), {})["dropped"] = True
    elif cmd == "VADD":
        # VADD index id vec_bytes meta_json
        meta = json.loads(dec(4)) if len(parts) > 4 and parts[4] else None
        idx_ops.setdefault(dec(1), {}).setdefault(
            "entries", {})[dec(2)] = (parts[3], meta)
    elif cmd == "VDEL":
        idx_ops.setdefault(dec(1), {}).setdefault(
            "entries", {})[dec(2)] = None
    elif cmd == "VMETA":
        ops = idx_ops.setdefault(dec(1), {})
        cur = ops.setdefault("entries", {}).get(dec(2))
        patch = json.loads(dec(3))
        if cur is not None:
            merged = dict(cur[1] or {})
            merged.update(patch)
            ops["entries"][dec(2)] = (cur[0], merged)
        else:
            ops.setdefault("meta_patches", []).append((dec(2), patch))
    elif cmd == "VCONFIG":
        # merged, not replaced: a later VCONFIG of other keys must not
        # undo an earlier one (each key's last value wins, as when they
        # were applied one by one)
        idx_ops.setdefault(dec(1), {}).setdefault("config", {}).update(
            json.loads(dec(2)))
    elif cmd == "GLINK":
        order.append(("GLINK", dec(1), dec(2), dec(3), float(dec(4)),
                      json.loads(dec(5)), float(dec(6))))
    elif cmd == "GUNLINK":
        order.append(("GUNLINK", dec(1), dec(2), dec(3), float(dec(4))))


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


def _is_zero(q: np.ndarray) -> bool:
    return not np.any(q)


def _cap_of(idx) -> int:
    return getattr(idx, "_cap", len(idx))


def _graph_to_state(g: KnowledgeGraph) -> dict:
    return {node: {rel: [[e.target, e.created_at, e.deleted_at, e.weight,
                          json.dumps(e.props)] for e in edges]
                   for rel, edges in rels.items()}
            for node, rels in g.out.items()}


def _graph_from_state(g: KnowledgeGraph, state: dict) -> None:
    for node, rels in state.items():
        for rel, edges in rels.items():
            for t, c, dl, w, props in edges:
                e = Edge(t, c, dl, w, json.loads(props))
                g.out.setdefault(node, {}).setdefault(rel, []).append(e)
                g.inc.setdefault(t, {}).setdefault(rel, []).append(
                    ReverseEdge(node, c, dl))


def _memory_to_state(m: fusion.MemoryConfig) -> dict:
    return {"enabled": m.enabled, "decay_half_life": m.decay_half_life,
            "decay_model": m.decay_model,
            "layers": {k: asdict(v) for k, v in m.layers.items()}}


def _memory_from_state(st: dict) -> fusion.MemoryConfig:
    return fusion.MemoryConfig(
        enabled=bool(st.get("enabled", False)),
        decay_half_life=float(st.get("decay_half_life", 30 * 24 * 3600.0)),
        decay_model=st.get("decay_model", "exponential"),
        layers={k: fusion.LayerConfig(**v)
                for k, v in (st.get("layers") or {}).items()})
