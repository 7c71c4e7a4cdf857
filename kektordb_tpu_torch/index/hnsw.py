"""HNSW index: the PyTorch port of kektordb_tpu/index/hnsw.py.

The host side owns the string <-> row id maps, the level-sampling RNG (a
numpy Generator, as in the reference, so both packages stamp the same
levels), free lists, capacity tiers, the unlinked backlog and the refine
cursor; the device side is a `GraphState` of tensors on `device`, built
and read by index/hnsw_kernels.py.

serve_mode: "auto" (the default) links the graph on every insert and
serves queries from the fused scan (ops/scan.py); "scan" never links;
"beam" serves from the graph's beam search. The graph's build records the
spans `graph.link` (a chunk), `graph.select` and `graph.upper` and the
counter `graph.linked_rows`; the beam read `index.descend`, `index.beam`
and the `beam.*` counters (tracing.py).

`serve_proj_dim` = p > 0 serves the scan from a cached [cap, p] bf16 PCA
projection of the arena, then re-ranks serve_proj_rerank candidates in
full dimension. `compress_serving` narrows an f32 arena to bf16 or int8
after a bulk build; `optimize_layout` relabels rows in BFS order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from .. import tracing
from ..ops import distance as dist
from ..ops import quantize as quant
from ..ops import scan as scanlib
from . import hnsw_kernels as K
from .base import IDMap


@dataclass
class HNSWConfig:
    """The reference's parameters that the port reads, with the
    reference's names and defaults. `m` and `lmax` size the state's graph
    tensors and `ml` the level sampling, so a state carries across."""
    m: int = 16
    ef_construction: int = 200
    ef_search: int = 100
    ml: float = 0.0                  # 0 -> 1/ln(m)
    seed: int = 42
    chunk: int = 512                 # graph build chunk
    flush_chunk: int = 64            # streaming insert micro-batch
    lmax: int = 8
    refine_ef: int = 0               # 0 -> ef_construction
    refine_batch: int = 512
    intra_k: int = 16                # intra-chunk brute-force candidates
    expand: int = 8                  # beam candidates expanded per step, build
    serve_expand: int = 4            # the same for the serving beam
    vacuum_deleted_ratio: float = 0.10
    fast_ef: int = 40                # add_batch(fast=True) ef floor
    serve_mode: str = "auto"         # "auto" | "scan" | "beam"
    # serve_mode "auto": past this many staged-but-unlinked rows, add()
    # links one chunk inline, so sustained writes keep the backlog bounded
    max_unlinked: int = 32768
    scan_exact: bool = False         # exact pass-A precision forms
    scan_precision: str = "high"     # "fast": single bf16 pass, no re-rank
    int8_symmetric: bool = False     # int8 arenas: quantize the query too
    # p > 0: pass A over a [cap, p] bf16 PCA projection of an f32 or bf16
    # arena, then an exact re-rank of serve_proj_rerank candidates
    serve_proj_dim: int = 0
    serve_proj_rerank: int = 128

    def resolved_ml(self) -> float:
        return self.ml if self.ml > 0 else 1.0 / math.log(max(self.m, 2))


SERVE_MODES = ("auto", "scan", "beam")


def check_supported(config: HNSWConfig) -> None:
    if config.serve_mode not in SERVE_MODES:
        raise ValueError(f"serve_mode must be one of {SERVE_MODES}, "
                         f"not {config.serve_mode!r}")


def encode_block(v32: torch.Tensor, *, metric: str, out_dtype: torch.dtype,
                 quantized: bool, quantizer) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Raw f32 block -> (arena-dtype codes, serving norms). For L2 the
    norms hold |x|^2 of the STORED values, so the scan's bias and its dots
    agree."""
    v = v32.float()
    if metric == dist.COSINE:
        v = dist.normalize(v)
    if quantized:
        if metric == dist.COSINE:
            return quant.quantize_rowwise(v)
        return quant.quantize(quantizer, v)
    enc = v.to(out_dtype)
    if metric == dist.L2:
        norms = torch.sum(enc.float() ** 2, dim=-1)
    else:
        norms = torch.zeros((v.shape[0],), device=v.device)
    return enc, norms


class HNSWIndex:
    MIN_CAP = 4096

    # Pass A emits [B, cap/G] f32 + int32; batches are chunked to keep
    # that under this many bytes
    SCAN_INTERMEDIATE_BYTES = 2 << 30

    def __init__(self, dim: int, metric: str = dist.L2,
                 precision: str = dist.F32,
                 config: Optional[HNSWConfig] = None, device="cuda"):
        if metric not in dist.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        if precision not in dist.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if precision == dist.BF16 and metric != dist.L2:
            raise ValueError("bfloat16 precision supports only euclidean")
        if precision == dist.INT8 and metric != dist.COSINE:
            raise ValueError("int8 precision supports only cosine")
        self.config = config or HNSWConfig()
        check_supported(self.config)
        self.dim = dim
        self.metric = metric
        self.precision = precision
        self.device = devlib.resolve(device)
        self.ids = IDMap()
        self.quantizer = quant.empty_state(self.device)
        self.rng = np.random.default_rng(self.config.seed)
        # counts assignments of `state`: the projected arena is cached per
        # version
        self._version = 0
        self._cap = self.MIN_CAP
        self._ucap = self._ucap_for(self.MIN_CAP)
        self.state = K.init_state(
            self._cap, dim, dist.storage_dtype(precision),
            m0=2 * self.config.m, lmax=self.config.lmax, mu=self.config.m,
            ucap=self._ucap, device=self.device)
        # host mirrors
        self._serve_quantized = False    # f32 index serving an int8 arena
        self._max_level = 0
        self._deleted_rows: set[int] = set()
        self._up_free: list[int] = []
        self._up_next = 0                # next never-used upper slot
        self._refine_cursor = 0
        self.needs_refine = False        # fast-built graph: beam ef boost
        # two-stage insert: _pending rows have ids but their vectors are
        # not staged yet; _unlinked rows are staged (scan-visible) but not
        # graph-linked yet
        self._pending: list[tuple[int, np.ndarray]] = []
        self._pending_rows: set[int] = set()
        self._unlinked: list[tuple[int, int]] = []   # (row, level)
        # serve_proj_dim: the PCA basis [D, p] (fit once) and the
        # projected arena (rebuilt per state version; never persisted)
        self._proj_basis: Optional[torch.Tensor] = None
        self._proj: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self._proj_version = -1

    @classmethod
    def from_reference_state(cls, arrays: Mapping[str, np.ndarray],
                             ids: Mapping[str, Sequence],
                             config: HNSWConfig, *, metric: str,
                             precision: str, device="cuda",
                             mirrors: Optional[Mapping] = None
                             ) -> "HNSWIndex":
        """A port index over a state carried across from the JAX index.

        `arrays`: the reference's GraphState leaves by field name, as numpy
        (`jax.device_get(idx.state)._asdict()`) or tensors. `ids`: its
        IDMap contents, {"row_to_ext": [...], "free": [...]}, and
        optionally "ext_to_row" (else the inverse of row_to_ext).
        `mirrors`: its host mirrors, any of deleted_rows, max_level,
        up_free, up_next (the next unused upper slot), unlinked (the
        (row, level) backlog), refine_cursor, needs_refine, abs_max (the
        trained quantizer's), serve_quantized and rng_state (`idx.rng.bit_generator.state`, so later adds sample
        the same levels). The reference index must be settled
        (`settle_for_serving()`): pending rows live only in its host
        memory."""
        idx = cls(arrays["vectors"].shape[1], metric, precision, config,
                  device=device)
        idx.state = K.GraphState(**{
            f: devlib.from_numpy(arrays[f], idx.device)
            for f in K.GraphState._fields})
        idx._cap = idx.state.vectors.shape[0]
        idx._ucap = idx.state.up_node.shape[0]
        idx.ids.row_to_ext = list(ids["row_to_ext"])
        idx.ids.ext_to_row = dict(ids["ext_to_row"]) if "ext_to_row" in ids \
            else {e: r for r, e in enumerate(idx.ids.row_to_ext)
                  if e is not None}
        idx.ids.free = [int(r) for r in ids.get("free", ())]
        idx.ids.rebuild_mask()
        m = mirrors or {}
        idx._deleted_rows = {int(r) for r in m.get("deleted_rows", ())}
        idx._max_level = int(m.get("max_level", int(idx.state.max_level)))
        idx._up_free = [int(s) for s in m.get("up_free", ())]
        idx._up_next = int(m.get("up_next", 0))
        idx._unlinked = [(int(r), int(lv)) for r, lv in m.get("unlinked", ())]
        idx._refine_cursor = int(m.get("refine_cursor", 0))
        idx.needs_refine = bool(m.get("needs_refine", False))
        idx._serve_quantized = bool(m.get("serve_quantized", False))
        if m.get("abs_max") is not None:
            idx.quantizer = quant.QuantizerState(
                torch.tensor(float(m["abs_max"]), device=idx.device), True)
        if m.get("rng_state") is not None:
            idx.rng.bit_generator.state = m["rng_state"]
        return idx

    # -- basic accessors -------------------------------------------------

    @property
    def state(self) -> K.GraphState:
        return self._state

    @state.setter
    def state(self, st: K.GraphState) -> None:
        self._state = st
        self._version += 1

    def invalidate_projection(self) -> None:
        """Drop the PCA basis and the projected arena (serve_proj_dim
        changed): both are derived data, refit at the next search."""
        self._proj_basis = None
        self._proj = None
        self._proj_version = -1

    def _proj_arena(self) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """([cap, p] bf16 projected arena, [cap] f32 projected norms) for
        the serve_proj_dim scan, or None where it does not apply (p = 0,
        p >= D, an int8 arena). One [cap, D] x [D, p] product per state
        version. The basis is the top-p PCA directions of the first
        (at most 65,536) staged rows, fit once: projections under an
        orthonormal basis lower-bound true distances, and the full-dim
        re-rank restores the order."""
        p = self.config.serve_proj_dim
        if not p or p >= self.dim or self.state.vectors.dtype == torch.int8:
            return None
        if self._proj is not None and self._proj_version == self._version:
            return self._proj
        if self._proj_basis is None:
            used = max(self.ids.capacity_used, 1)
            sample = self.state.vectors[:min(used, 65536)].float()
            self._proj_basis = torch.from_numpy(quant.fit_pca_basis(
                sample.cpu().numpy(), p)).to(self.device)
        P = self.state.vectors.float() @ self._proj_basis
        self._proj = (P.to(torch.bfloat16), torch.sum(P * P, dim=-1))
        self._proj_version = self._version
        return self._proj

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def deleted_count(self) -> int:
        return len(self._deleted_rows)

    def memory_report(self) -> dict:
        """Device bytes held by the index state, capacity and occupancy."""
        return {
            "device_bytes": int(sum(t.numel() * t.element_size()
                                    for t in self.state)),
            "capacity_rows": int(self._cap),
            "rows_used": len(self.ids),
        }

    # -- encoding ----------------------------------------------------------

    def _quantized(self) -> bool:
        return self.precision == dist.INT8 or self._serve_quantized

    def _encode(self, vectors: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor]:
        v = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(
            self.device)
        if self.precision == dist.INT8 and not self.quantizer.trained:
            self.quantizer = quant.train(
                dist.normalize(v) if self.metric == dist.COSINE else v)
        return encode_block(v, metric=self.metric,
                            out_dtype=self.state.vectors.dtype,
                            quantized=self._quantized(),
                            quantizer=self.quantizer)

    def _encode_query(self, queries: np.ndarray, scan: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Serving-side query encode. On the scan, int8 arenas keep the
        query float (ASYMMETRIC scoring) unless `int8_symmetric`; the beam
        encodes it like a stored row (symmetric)."""
        if self._quantized() and scan and not self.config.int8_symmetric:
            v = torch.from_numpy(np.ascontiguousarray(queries)).to(
                self.device)
            if self.metric == dist.COSINE:
                return dist.normalize(v), torch.ones(v.shape[0],
                                                     device=self.device)
            return v, torch.zeros(v.shape[0], device=self.device)
        return self._encode(queries)

    def _quantum(self) -> Optional[torch.Tensor]:
        """abs_max / 127 as a 0-dim device tensor for int8 arenas."""
        if self.state.vectors.dtype == torch.int8:
            return self.quantizer.abs_max / 127.0
        return None

    # -- capacity ----------------------------------------------------------

    def _ucap_for(self, cap: int) -> int:
        return max(2 * cap // max(self.config.m, 2), 256)

    def _grow_for(self, extra: int) -> None:
        need = self.ids.capacity_used + extra
        if need <= self._cap:
            return
        new_cap = self._cap
        while new_cap < need:
            new_cap *= 2
        new_ucap = max(self._ucap_for(new_cap), self._ucap)
        self.state = K.grow_state(self.state, new_cap, new_ucap)
        self._cap, self._ucap = new_cap, new_ucap

    def _sample_levels(self, n: int) -> np.ndarray:
        ml = self.config.resolved_ml()
        u = self.rng.random(n)
        lv = np.floor(-np.log(np.maximum(u, 1e-12)) * ml).astype(np.int32)
        return np.minimum(lv, min(self._max_level + 1, self.config.lmax))

    # -- write path ----------------------------------------------------------

    def add(self, ext_id: str, vector: np.ndarray) -> None:
        """Streaming insert: the row is allocated now, its vector staged at
        the next micro-batch boundary (search stages pending rows first,
        so a search always sees it) and its graph links made lazily."""
        if ext_id in self.ids:
            raise KeyError(f"id already present: {ext_id}")
        v = np.asarray(vector, np.float32).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {v.shape[0]}")
        self._grow_for(1)
        row = self.ids.alloc(ext_id)
        self._pending.append((row, v))
        self._pending_rows.add(row)
        if len(self._pending) >= self.config.flush_chunk:
            self._stage_pending()
            if (self.config.serve_mode == "auto"
                    and len(self._unlinked) > self.config.max_unlinked):
                self.ensure_linked(limit=self.config.chunk)

    def add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray,
                  fast: bool = False, link: Optional[bool] = None) -> None:
        """Bulk insert. link=None follows serve_mode ("scan" never links).
        link=False stages the rows in chunks of max(chunk, 8192), scan-only;
        otherwise each chunk of `chunk` rows goes through the full graph
        insert at ef_construction. fast=True floors ef at
        max(fast_ef, 2 m) and sets needs_refine, so beam queries get an ef
        boost until the graph is refined."""
        if link is None:
            link = self.config.serve_mode != "scan"
        vectors = np.asarray(vectors, np.float32)
        if vectors.shape != (len(ext_ids), self.dim):
            raise ValueError(
                f"expected shape ({len(ext_ids)}, {self.dim}), "
                f"got {vectors.shape}")
        seen = set()
        for e in ext_ids:
            if e in self.ids or e in seen:
                raise KeyError(f"id already present: {e}")
            seen.add(e)
        if not link:
            self._stage_pending()
            self._grow_for(len(ext_ids))
            C = max(self.config.chunk, 8192)
            for i in range(0, len(ext_ids), C):
                block = ext_ids[i:i + C]
                rows = np.fromiter((self.ids.alloc(e) for e in block),
                                   np.int32, len(block))
                self._stage_block(rows, vectors[i:i + C])
            return
        self.flush()
        C = self.config.chunk
        ef = max(self.config.fast_ef, 2 * self.config.m) if fast \
            else self.config.ef_construction
        for i in range(0, len(ext_ids), C):
            self._commit(ext_ids[i:i + C], vectors[i:i + C], ef)
        self._adopt_unreachable()
        if fast:
            self.needs_refine = True

    def _stage_block(self, rows: np.ndarray, vectors: np.ndarray) -> None:
        """Encode + arena write + level stamp: the rows become
        scan-visible and join the unlinked backlog (unless scan-only)."""
        levels = self._sample_levels(rows.size)
        enc, norms = self._encode(vectors)
        self.state = K.stage_vectors(
            self.state, self._rows(rows), enc, norms, self._rows(levels))
        if self.config.serve_mode != "scan":
            self._unlinked.extend(zip(rows.tolist(), levels.tolist()))

    def _stage_pending(self) -> None:
        P = self.config.flush_chunk
        while self._pending:
            take = self._pending[:P]
            self._pending = self._pending[P:]
            rows = np.fromiter((r for r, _ in take), np.int32, len(take))
            self._stage_block(rows, np.stack([v for _, v in take]))
            self._pending_rows.difference_update(rows.tolist())

    def _rows(self, a: np.ndarray) -> torch.Tensor:
        """Host int32 array -> int32 tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def ensure_linked(self, limit: Optional[int] = None) -> None:
        """Link the staged-but-unlinked backlog into the graph, a chunk at
        a time; `limit` bounds the rows drained."""
        self._stage_pending()
        C = self.config.chunk
        drained = 0
        while self._unlinked and (limit is None or drained < limit):
            take = self._unlinked[:C]
            self._unlinked = self._unlinked[C:]
            rows, lvls = np.array(take, np.int32).T
            with tracing.span("graph.link", n=len(take)):
                self.state = K.link_chunk(
                    self.state, self._rows(rows), self._rows(lvls),
                    metric=self.metric, ef=self.config.ef_construction,
                    m=self.config.m, intra_k=self.config.intra_k,
                    dual=bool(self._deleted_rows), expand=self.config.expand)
                self._register_upper([(r, lv) for r, lv in take if lv >= 1])
            tracing.count("graph.linked_rows", len(take))
            drained += len(take)
        if drained:
            self._adopt_unreachable()

    def flush(self) -> None:
        """Stage and link everything."""
        self.ensure_linked()

    def _commit(self, ext_ids: Sequence[str], vectors: np.ndarray,
                ef: int) -> None:
        """One chunk of rows through the full insert. The reference pads
        a chunk with -1 rows to a static shape for its compiler; eager
        torch needs no padding, and padding rows change no real row's
        result."""
        n = len(ext_ids)
        self._grow_for(n)
        rows = np.fromiter((self.ids.alloc(e) for e in ext_ids), np.int32, n)
        levels = self._sample_levels(n)
        with tracing.span("graph.link", n=n):
            enc, norms = self._encode(vectors)
            self.state = K.insert_chunk(
                self.state, self._rows(rows), enc, norms, self._rows(levels),
                metric=self.metric, ef=ef, m=self.config.m,
                intra_k=self.config.intra_k, dual=bool(self._deleted_rows),
                expand=self.config.expand)
            self._register_upper([(int(r), int(lv)) for r, lv in
                                  zip(rows, levels) if lv >= 1])
        tracing.count("graph.linked_rows", n)

    def _adopt_unreachable(self) -> None:
        """After a pass of links or a rewrite of rows (refine, vacuum):
        every linked row is linked from a row that the entry reaches
        (`K.adopt_unreachable`), so that a beam can find it; the counter
        `graph.adopted_rows` counts the rows that needed it."""
        n = self.ids.capacity_used
        linked = self.state.levels[:n] >= 0
        if self._unlinked:
            linked[self._rows(np.array([r for r, _ in self._unlinked]))
                   .long()] = False
        adopted = K.adopt_unreachable(self.state, linked, self.metric)
        if adopted:
            tracing.count("graph.adopted_rows", adopted)

    def _register_upper(self, ups: list[tuple[int, int]]) -> None:
        """Insert (row, level >= 1) nodes into the upper exact-KNN
        layers."""
        if not ups:
            return
        unodes = np.array([r for r, _ in ups], np.int32)
        uslots = np.array([self._alloc_up_slot() for _ in ups], np.int32)
        self._max_level = max(self._max_level, max(lv for _, lv in ups))
        with tracing.span("graph.upper", n=len(ups)):
            self.state = K.update_upper(self.state, self._rows(unodes),
                                        self._rows(uslots),
                                        metric=self.metric,
                                        top_level=self._max_level)

    def _alloc_up_slot(self) -> int:
        if self._up_free:
            return self._up_free.pop()
        s = self._up_next
        self._up_next += 1
        if s >= self._ucap:
            # an unlucky level draw overflowed the 2x headroom
            self.state = K.grow_state(self.state, self._cap, self._ucap * 2)
            self._ucap *= 2
        return s

    # -- concurrent-serving protocol (engine read/write lock split) ----------

    def settle_for_serving(self, mode: Optional[str] = None) -> None:
        """Commit every pending write a search would otherwise perform, so
        that the search itself is pure (run under the engine's exclusive
        lock): staging for the scan, staging and linking for the beam."""
        if (mode or self.config.serve_mode) == "beam":
            self.flush()
        else:
            self._stage_pending()

    def serving_dirty(self, mode: Optional[str] = None) -> bool:
        """True if a search would mutate state (pending stage/link work)."""
        if (mode or self.config.serve_mode) == "beam":
            return bool(self._pending or self._unlinked)
        return bool(self._pending)

    # -- delete / maintenance -------------------------------------------------

    def delete(self, ext_id: str) -> bool:
        """Soft delete: the row stays traversable but leaves every result;
        vacuum() reclaims it."""
        if ext_id not in self.ids:
            return False
        row = self.ids.ext_to_row[ext_id]
        if row in self._pending_rows:
            # never reached the arena: drop it host-side
            self._pending = [(r, v) for r, v in self._pending if r != row]
            self._pending_rows.discard(row)
            self.ids.release(ext_id)
            return True
        self.ids.unmap(ext_id)
        self._deleted_rows.add(row)
        self.state = K.mark_deleted(
            self.state, torch.tensor([row], dtype=torch.int32,
                                     device=self.device))
        return True

    def run_maintenance_cycle(self) -> str:
        """Link the backlog, then vacuum when the deleted ratio crosses
        the threshold, otherwise refine a cursor batch. A scan index has
        no graph: it stages and vacuums only."""
        scan_only = self.config.serve_mode == "scan"
        if scan_only:
            self._stage_pending()
        else:
            self.ensure_linked()
        total = self.ids.capacity_used
        if total and len(self._deleted_rows) / total \
                >= self.config.vacuum_deleted_ratio:
            self.vacuum()
            return "vacuum"
        if scan_only:
            return "idle"
        self.refine_step()
        return "refine"

    def refine_step(self, rows: Optional[np.ndarray] = None) -> None:
        """One refine batch: the given rows, or the next refine_batch live
        rows from the cursor; then the rows the rewrite left unreachable
        are linked (`_adopt_unreachable`)."""
        B = self.config.refine_batch
        if rows is None:
            live = self._live_rows()
            if live.size == 0:
                return
            start = self._refine_cursor % live.size
            rows = live[(start + np.arange(min(B, live.size))) % live.size]
            self._refine_cursor = int((start + B) % max(live.size, 1))
        self._refine(rows[:B])
        self._adopt_unreachable()

    def _refine(self, rows: np.ndarray) -> None:
        self.state = K.refine_chunk(
            self.state, self._rows(rows), metric=self.metric,
            ef=self.config.refine_ef or self.config.ef_construction,
            m_out=2 * self.config.m)

    def turbo_refine(self, passes: int = 1) -> None:
        """Refine every live row (after a bulk import) and clear the
        needs_refine ef boost. A scan index only stages."""
        if self.config.serve_mode == "scan":
            self._stage_pending()
            self.needs_refine = False
            return
        self.flush()
        live = self._live_rows()
        B = self.config.refine_batch
        for _ in range(passes):
            for i in range(0, live.size, B):
                self._refine(live[i:i + B])
        self._adopt_unreachable()
        self.needs_refine = False

    def vacuum(self) -> int:
        """Reconnect the live rows that point at deleted ones (refine),
        re-elect the entry point if it was deleted, purge the deleted rows
        and recycle their slots; returns how many were purged. A scan index
        has no graph to heal and purges directly."""
        if self.config.serve_mode == "scan":
            self._stage_pending()
            dead_set = self._deleted_rows
            self._unlinked = [(r, lv) for r, lv in self._unlinked
                              if r not in dead_set]
        else:
            self.flush()
        if not self._deleted_rows:
            return 0
        if self.config.serve_mode != "scan":
            affected = K.rows_referencing_deleted(self.state)
            aff_rows = torch.nonzero(affected)[:, 0].int().cpu().numpy()
            B = self.config.refine_batch
            for i in range(0, aff_rows.size, B):
                self._refine(aff_rows[i:i + B])
        dead = np.fromiter(self._deleted_rows, np.int32)
        dead_slots = self.state.up_of.cpu().numpy()[dead]
        dead_slots = dead_slots[dead_slots >= 0].astype(np.int32)
        if int(self.state.entry) in self._deleted_rows:
            levels = self.state.levels.cpu().numpy()
            live = self._live_rows()
            entry, self._max_level = -1, 0
            if live.size:
                entry = int(live[np.argmax(levels[live])])
                self._max_level = int(levels[entry])
            self.state.entry.fill_(entry)
            self.state.max_level.fill_(self._max_level)
        self.state = K.purge_rows(self.state, self._rows(dead),
                                  self._rows(dead_slots))
        n = len(self._deleted_rows)
        for r in self._deleted_rows:
            self.ids.free.append(int(r))
            self.ids.row_to_ext[r] = None
        self._up_free.extend(int(s) for s in dead_slots)
        self._deleted_rows.clear()
        if self.config.serve_mode != "scan":
            self._adopt_unreachable()
        return n

    def _live_rows(self) -> np.ndarray:
        levels = self.state.levels[: self.ids.capacity_used].cpu().numpy()
        live = np.nonzero(levels >= 0)[0].astype(np.int32)
        if self._deleted_rows:
            live = live[~np.isin(live, np.fromiter(self._deleted_rows,
                                                   np.int32))]
        return live

    # -- query path -----------------------------------------------------------

    def prepare_allow(self, mask: np.ndarray) -> torch.Tensor:
        """Host bool mask -> [cap] bool tensor on the device, which search()
        takes without a transfer (the engine's mask cache keeps it)."""
        a = np.asarray(mask, bool)
        if a.size < self._cap:
            a = np.pad(a, (0, self._cap - a.size))
        return torch.from_numpy(np.ascontiguousarray(a[: self._cap])).to(
            self.device)

    def _allow_to_device(self, allow_rows) -> Optional[torch.Tensor]:
        """An allow-list argument -> [cap] bool device mask. Takes a
        [cap] bool tensor as it is, a host bool mask, or host row ids."""
        if allow_rows is None:
            return None
        if isinstance(allow_rows, torch.Tensor) \
                and allow_rows.dtype == torch.bool \
                and allow_rows.shape == (self._cap,):
            return allow_rows.to(self.device)
        a = np.asarray(allow_rows)
        if a.dtype == bool:
            return self.prepare_allow(a)
        rows = a.astype(np.int64).reshape(-1)
        rows = rows[(rows >= 0) & (rows < self._cap)]   # -1 pads dropped
        allow = torch.zeros(self._cap, dtype=torch.bool, device=self.device)
        allow[torch.from_numpy(rows).to(self.device)] = True
        return allow

    def _queries(self, queries) -> np.ndarray:
        """Check the query batch: [D] or [B, D] -> [B, D] float32."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[-1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[-1]} != index dim {self.dim}")
        return queries

    def search(self, queries: np.ndarray, k: int, *,
               ef: Optional[int] = None, allow_rows=None,
               mode: Optional[str] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: [B, D] -> (dists [B, k], rows [B, k]; -1 pads).
        serve_mode "auto" / "scan": the fused scan; "beam" (or
        mode="beam"): the graph's beam search at ef (default ef_search)."""
        use_scan = (mode or self.config.serve_mode) != "beam"
        if use_scan:
            self._stage_pending()
        else:
            self.flush()
        queries = self._queries(queries)
        B = queries.shape[0]
        if len(self.ids) == 0 or (not use_scan and int(self.state.entry) < 0):
            return (np.full((B, k), np.inf, np.float32),
                    np.full((B, k), -1, np.int32))
        q, qn = self._encode_query(queries, scan=use_scan)
        allow = self._allow_to_device(allow_rows)
        if use_scan:
            d, rows = self._scan_search_device(q, qn, B, k, allow)
            d_np, i_np = d.cpu().numpy(), rows.cpu().numpy()
        else:
            d_np, i_np = self._beam_search_traced(q, qn, k, ef, allow)
        if self._serve_quantized and self.metric == dist.L2 and (
                not use_scan or self.config.int8_symmetric):
            # the beam and symmetric int8 scan score L2 in the quantized
            # domain
            quantum = float(self.quantizer.abs_max) / 127.0
            d_np = d_np * (quantum * quantum)
        return d_np, i_np

    def _beam_search_traced(self, q, qn, k: int, ef: Optional[int],
                            allow) -> tuple[np.ndarray, np.ndarray]:
        """The beam read on the host: the span `index.descend` over the
        upper layers' descent, `index.beam` over the level-0 beam through
        the copy back, and the counters `beam.searches`,
        `beam.iterations`, `beam.done_checks` and `beam.scored` (summed
        on the device, read once with the answers)."""
        B = q.shape[0]
        with tracing.span("index.descend", n=B):
            seeds = K.descend(self.state, q, qn, self.metric)
        stats = K.BeamStats()
        with tracing.span("index.beam", n=B):
            d, rows = self._beam_search_device(q, qn, k, ef, allow,
                                               seeds=seeds, stats=stats)
            d_np, i_np = d.cpu().numpy(), rows.cpu().numpy()
            scored = int(stats.scored)
        tracing.count("beam.searches")
        tracing.count("beam.iterations", stats.iterations)
        tracing.count("beam.done_checks", stats.done_checks)
        tracing.count("beam.scored", scored)
        return d_np, i_np

    def _beam_search_device(self, q, qn, k: int, ef: Optional[int],
                            allow, seeds=None, stats=None):
        """Beam serving: ef boost for a fast-built graph, and the dual pool
        when a filter or a deletion makes rows ineligible. The batch runs
        as it is: eager torch has no compiled program per batch size that
        padding would let requests share. `seeds` and `stats` go to
        `beam_search`."""
        ef = ef or self.config.ef_search
        if self.needs_refine:
            ef = min(max(ef, 80), 200)
        ef = max(ef, k)
        d, rows = K.beam_search(
            self.state, q, qn, metric=self.metric, ef=ef, allow=allow,
            dual=allow is not None or bool(self._deleted_rows),
            expand=self.config.serve_expand, seeds=seeds, stats=stats)
        return d[:, :k], rows[:, :k]

    def search_device(self, queries: np.ndarray, k: int, *, allow_rows=None):
        """Scan serving with device-resident results: (d [B, k] f32,
        rows [B, k] int32, l2_rescale float), or None where this index
        does not serve from the scan (serve_mode "beam", or empty)."""
        if self.config.serve_mode == "beam":
            return None
        self._stage_pending()
        queries = self._queries(queries)
        if len(self.ids) == 0:
            return None
        q, qn = self._encode_query(queries)
        d, rows = self._scan_search_device(q, qn, queries.shape[0], k,
                                           self._allow_to_device(allow_rows))
        scale = 1.0
        if self._serve_quantized and self.metric == dist.L2 \
                and self.config.int8_symmetric:
            scale = (float(self.quantizer.abs_max) / 127.0) ** 2
        return d, rows, scale

    def _scan_search_device(self, q, qn, B: int, k: int, allow):
        """Pad the batch to a power of two (>= 16, >= 32 for int8), chunk
        it so pass A's [B, cap/G] output stays under
        SCAN_INTERMEDIATE_BYTES, and fetch kf >= 32 candidates (or take
        the projected read, `_proj_search`)."""
        min_b = 32 if self.state.vectors.dtype == torch.int8 else 16
        Bp = min_b
        while Bp < B:
            Bp *= 2
        row_bytes = (self._cap // scanlib.g_for(self._cap)) * 8
        b_max = max(min_b, self.SCAN_INTERMEDIATE_BYTES // max(row_bytes, 1))
        bp2 = min_b
        while bp2 * 2 <= b_max:
            bp2 *= 2
        if Bp > bp2:
            outs = [self._scan_search_device(
                q[i:i + bp2], qn[i:i + bp2], min(bp2, B - i), k, allow)
                for i in range(0, B, bp2)]
            return (torch.cat([d for d, _ in outs]),
                    torch.cat([r for _, r in outs]))
        if Bp != B:
            q = torch.cat([q, q.new_zeros((Bp - B, q.shape[1]))])
            qn = torch.cat([qn, qn.new_zeros(Bp - B)])
        proj = None if self.config.scan_exact else self._proj_arena()
        if proj is not None:
            d, rows = self._proj_search(proj, q, qn, k, allow)
            return d[:B, :k], rows[:B, :k]
        kf = 32
        while kf < k:
            kf *= 2
        kf = min(kf, self._cap // scanlib.g_for(self._cap))
        d, rows = scanlib.scan_search(
            self.state.vectors, self.state.norms, self.state.levels,
            self.state.deleted, allow, q, qn, kf, metric=self.metric,
            mode="exact" if self.config.scan_exact else "approx",
            fast=self.config.scan_precision == "fast",
            quantum=self._quantum())
        return d[:B, :k], rows[:B, :k].int()

    def _proj_search(self, proj, q, qn, k: int, allow):
        """The projected read: pass A's bf16 form over the [cap, p]
        projection picks C = max(serve_proj_rerank, 2k) candidates (at
        most cap / G), gather-distance re-ranks them in full dimension,
        then a stable sort. (d [Bp, C] ascending, rows [Bp, C] int32, -1
        where d is inf)."""
        Pa, pn = proj
        qp = (q.float() @ self._proj_basis).to(torch.bfloat16)
        C = min(max(self.config.serve_proj_rerank, 2 * k),
                self._cap // scanlib.g_for(self._cap))
        _, rows = scanlib.scan_search(
            Pa, pn, self.state.levels, self.state.deleted, allow, qp,
            torch.zeros(q.shape[0], device=q.device), C, metric=self.metric,
            mode="approx", fast=True)
        d = dist.gathered(self.state.vectors, rows, q, self.metric,
                          corpus_norms=self.state.norms, query_norms=qn,
                          quantum=self._quantum())
        d = torch.where(rows < 0, scanlib.INF, d)
        d, order = torch.sort(d, dim=1, stable=True)
        rows = torch.gather(rows, 1, order)
        rows = torch.where(torch.isinf(d), -1, rows)
        return torch.clamp_min(d, 0.0), rows.int()

    def compress_serving(self, dtype: str = "bfloat16",
                         _pretrained: bool = False) -> None:
        """Narrow the stored vectors of a float32 index for serving after a
        bulk build; the graph is kept, later inserts encode into the
        narrowed arena. "bfloat16" keeps |x|^2 of the narrowed values for
        L2. "int8": cosine takes per-row scales (quantize_rowwise); L2
        trains the quantizer on the used rows and scores float queries
        against the codes (asymmetric), or in the quantized domain with
        int8_symmetric and on the beam, rescaled in search(). With
        `_pretrained` the L2 quantizer is kept as it is (a sharded index
        shares one across its shards)."""
        self._stage_pending()
        if self.precision != dist.F32:
            raise ValueError("compress_serving applies to float32 indexes")
        vecs = self.state.vectors.float()
        if dtype == "int8":
            if self.metric == dist.COSINE:
                codes, norms = quant.quantize_rowwise(vecs)
            else:
                if not _pretrained:
                    used = max(self.ids.capacity_used, 1)
                    self.quantizer = quant.train(vecs[:used])
                codes, norms = quant.quantize(self.quantizer, vecs)
            self.state = self.state._replace(vectors=codes, norms=norms)
            self._serve_quantized = True
            return
        target = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
        vecs = self.state.vectors.to(target)
        norms = self.state.norms
        if self.metric == dist.L2:
            norms = torch.sum(vecs.float() ** 2, dim=-1)
        self.state = self.state._replace(vectors=vecs, norms=norms)

    def optimize_layout(self) -> None:
        """Relabel rows in BFS order from the entry point over the level-0
        graph (unreached rows keep their order at the end), so a beam's
        neighbour reads land near each other. The BFS runs on the host,
        the permutation is gathered on the device, and the id maps follow.
        Skipped when rows were freed (slot reuse would interleave with the
        order) and on an index without a graph."""
        self.flush()
        if self._deleted_rows or self.ids.free:
            return
        used = self.ids.capacity_used
        entry = int(self.state.entry)
        if used == 0 or entry < 0:
            return
        nbrs = self.state.nbrs[:used].cpu().numpy()
        visited = np.zeros(used, bool)
        order = np.empty(used, np.int32)
        pos = 0
        frontier = np.array([entry], np.int32)
        visited[entry] = True
        while frontier.size:
            order[pos:pos + frontier.size] = frontier
            pos += frontier.size
            cand = nbrs[frontier].ravel()
            cand = np.unique(cand[(cand >= 0) & (cand < used)])
            cand = cand[~visited[cand]]
            visited[cand] = True
            frontier = cand
        rest = np.nonzero(~visited)[0]
        order[pos:pos + rest.size] = rest
        old2new = np.empty(used, np.int32)
        old2new[order] = np.arange(used, dtype=np.int32)

        st = self.state
        perm = torch.from_numpy(np.concatenate(
            [order, np.arange(used, self._cap, dtype=np.int32)])).to(
            self.device).long()
        o2n = torch.from_numpy(old2new).to(self.device)

        def remap(a: torch.Tensor) -> torch.Tensor:
            ok = (a >= 0) & (a < used)
            return torch.where(ok, o2n[a.clamp(0, used - 1).long()], a)

        self.state = st._replace(
            vectors=st.vectors[perm], norms=st.norms[perm],
            nbrs=remap(st.nbrs)[perm], levels=st.levels[perm],
            deleted=st.deleted[perm], up_of=st.up_of[perm],
            up_node=remap(st.up_node), up_nbrs=remap(st.up_nbrs),
            entry=torch.tensor(int(old2new[entry]), dtype=torch.int32,
                               device=self.device))
        row_to_ext: list[Optional[str]] = [None] * used
        for old_row, ext in enumerate(self.ids.row_to_ext[:used]):
            if ext is not None:
                row_to_ext[int(old2new[old_row])] = ext
                self.ids.ext_to_row[ext] = int(old2new[old_row])
        self.ids.row_to_ext = row_to_ext
        self.ids.rebuild_mask()      # new version: row-keyed caches refresh

    def get_vector(self, ext_id: str) -> Optional[np.ndarray]:
        """The stored vector (normalized for cosine, dequantized for
        int8)."""
        self._stage_pending()
        row = self.ids.get(ext_id)
        if row is None:
            return None
        v = self.state.vectors[row].float().cpu().numpy()
        if self._quantized():
            if self.metric == dist.COSINE:
                v = v / max(float(np.linalg.norm(v)), 1e-12)
            else:
                v = v * (float(self.quantizer.abs_max) / 127.0)
        return v.astype(np.float32)

    def search_ids(self, queries: np.ndarray, k: int, **kw):
        """(ext_id, dist) pairs per query."""
        d, rows = self.search(queries, k, **kw)
        return [[(self.ids.row_to_ext[r], float(d[b, j]))
                 for j, r in enumerate(rows[b])
                 if r >= 0 and self.ids.row_to_ext[r] is not None]
                for b in range(rows.shape[0])]
