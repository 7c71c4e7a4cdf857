"""HNSW index, scan-serving half: the PyTorch port of
kektordb_tpu/index/hnsw.py under `serve_mode="scan"`.

The host side owns the string <-> row id maps, the level-sampling RNG (a
numpy Generator, as in the reference, so both packages stamp the same
levels), free lists and capacity tiers; the device side is a `GraphState`
of tensors on `device`. Reads go through the fused scan (ops/scan.py).

Not ported yet, and refused with NotImplementedError rather than served
some other way: the graph build and beam serving (`serve_mode` "auto" and
"beam", `add_batch(link=True)`), the PCA-projected pass A
(`serve_proj_dim`) and `compress_serving`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..ops import distance as dist
from ..ops import quantize as quant
from ..ops import scan as scanlib
from . import hnsw_kernels as K
from .base import IDMap

GRAPH_TODO = ("the graph build and beam serving are not ported yet "
              "(ROADMAP.md, queue 1, item 7)")


@dataclass
class HNSWConfig:
    """The reference's parameters that the scan-serving index reads, with
    the reference's names and defaults. `m` and `lmax` size the state's
    graph tensors and `ml` the level sampling, so a state carries across;
    the graph-build and beam fields (ef_construction, ef_search, refine_*,
    expand, ...) come with the graph build (ROADMAP.md, queue 1, item 7)."""
    m: int = 16
    ml: float = 0.0                  # 0 -> 1/ln(m)
    seed: int = 42
    chunk: int = 512
    flush_chunk: int = 64            # streaming insert micro-batch
    lmax: int = 8
    vacuum_deleted_ratio: float = 0.10
    serve_mode: str = "auto"         # only "scan" is ported
    scan_exact: bool = False         # exact pass-A precision forms
    scan_precision: str = "high"     # "fast": single bf16 pass, no re-rank
    int8_symmetric: bool = False     # int8 arenas: quantize the query too
    serve_proj_dim: int = 0          # > 0 is refused (check_supported)

    def resolved_ml(self) -> float:
        return self.ml if self.ml > 0 else 1.0 / math.log(max(self.m, 2))


def check_supported(config: HNSWConfig) -> None:
    """Refuse the options whose code paths are not ported yet."""
    if config.serve_mode != "scan":
        raise NotImplementedError(
            f"serve_mode={config.serve_mode!r}: {GRAPH_TODO}; "
            "use serve_mode='scan'")
    if config.serve_proj_dim:
        raise NotImplementedError(
            "serve_proj_dim > 0 (PCA-projected pass A) is not ported yet "
            "(ROADMAP.md, queue 1, item 7)")


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
        # rows with ids allocated whose vectors are not staged yet
        self._pending: list[tuple[int, np.ndarray]] = []
        self._pending_rows: set[int] = set()

    @classmethod
    def from_reference_state(cls, arrays: Mapping[str, np.ndarray],
                             ids: Mapping[str, Sequence],
                             config: HNSWConfig, *, metric: str,
                             precision: str, device="cuda",
                             mirrors: Optional[Mapping] = None
                             ) -> "HNSWIndex":
        """A port index over a state carried across from the JAX index.

        `arrays`: the reference's GraphState leaves by field name, as numpy
        (`jax.device_get(idx.state)._asdict()`). `ids`: its IDMap contents,
        {"row_to_ext": [...], "free": [...]}. `mirrors`: its host mirrors,
        any of deleted_rows, max_level, up_free, abs_max (the
        trained quantizer's), serve_quantized and rng_state
        (`idx.rng.bit_generator.state`, so later adds sample the same
        levels). The reference index must be settled
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
        idx.ids.ext_to_row = {e: r for r, e in enumerate(idx.ids.row_to_ext)
                              if e is not None}
        idx.ids.free = [int(r) for r in ids.get("free", ())]
        idx.ids.rebuild_mask()
        m = mirrors or {}
        idx._deleted_rows = {int(r) for r in m.get("deleted_rows", ())}
        idx._max_level = int(m.get("max_level", 0))
        idx._up_free = [int(s) for s in m.get("up_free", ())]
        idx._serve_quantized = bool(m.get("serve_quantized", False))
        if m.get("abs_max") is not None:
            idx.quantizer = quant.QuantizerState(
                torch.tensor(float(m["abs_max"]), device=idx.device), True)
        if m.get("rng_state") is not None:
            idx.rng.bit_generator.state = m["rng_state"]
        return idx

    # -- basic accessors -------------------------------------------------

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

    def _encode_query(self, queries: np.ndarray
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Serving-side query encode. int8 arenas keep the query float
        (ASYMMETRIC scoring) unless `int8_symmetric`."""
        if self._quantized() and not self.config.int8_symmetric:
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
        """Streaming insert: the row is allocated now and its vector staged
        at the next micro-batch boundary (search stages pending rows
        first, so a search always sees it)."""
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

    def add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray,
                  fast: bool = False, link: Optional[bool] = None) -> None:
        """Bulk insert, staged in chunks of max(chunk, 8192) rows. Only
        `link=False` (the scan-only index) is ported; `fast` is a
        graph-build hint."""
        if link:
            raise NotImplementedError(f"add_batch(link=True): {GRAPH_TODO}")
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
        self._stage_pending()
        self._grow_for(len(ext_ids))
        C = max(self.config.chunk, 8192)
        for i in range(0, len(ext_ids), C):
            block = ext_ids[i:i + C]
            rows = np.fromiter((self.ids.alloc(e) for e in block),
                               np.int32, len(block))
            self._stage_block(rows, vectors[i:i + C])

    def _stage_block(self, rows: np.ndarray, vectors: np.ndarray) -> None:
        """Encode + arena write + level stamp: the rows become
        scan-visible."""
        levels = self._sample_levels(rows.size)
        enc, norms = self._encode(vectors)
        self.state = K.stage_vectors(
            self.state, torch.from_numpy(rows).to(self.device), enc, norms,
            torch.from_numpy(levels).to(self.device))

    def _stage_pending(self) -> None:
        P = self.config.flush_chunk
        while self._pending:
            take = self._pending[:P]
            self._pending = self._pending[P:]
            rows = np.fromiter((r for r, _ in take), np.int32, len(take))
            self._stage_block(rows, np.stack([v for _, v in take]))
            self._pending_rows.difference_update(rows.tolist())

    # -- concurrent-serving protocol (engine read/write lock split) ----------

    def settle_for_serving(self, mode: Optional[str] = None) -> None:
        """Commit every pending write a search would otherwise perform, so
        that the search itself is pure (run under the engine's exclusive
        lock)."""
        if (mode or self.config.serve_mode) == "beam":
            raise NotImplementedError(f"mode='beam': {GRAPH_TODO}")
        self._stage_pending()

    def serving_dirty(self) -> bool:
        """True if a search would mutate state (pending stage work)."""
        return bool(self._pending)

    # -- delete / maintenance -------------------------------------------------

    def delete(self, ext_id: str) -> bool:
        """Soft delete: the row leaves every result; vacuum() reclaims it."""
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
        """Stage pending rows, then vacuum when the deleted ratio crosses
        the threshold. A scan index has no graph to refine."""
        self._stage_pending()
        total = self.ids.capacity_used
        if total and len(self._deleted_rows) / total \
                >= self.config.vacuum_deleted_ratio:
            self.vacuum()
            return "vacuum"
        return "idle"

    def vacuum(self) -> int:
        """Purge deleted rows and recycle their slots; returns how many. A
        scan index has no graph to heal, so it purges directly (the entry
        point is re-elected for states carried across with a graph)."""
        self._stage_pending()
        if not self._deleted_rows:
            return 0
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
        self.state = K.purge_rows(self.state,
                                  torch.from_numpy(dead).to(self.device),
                                  torch.from_numpy(dead_slots).to(
                                      self.device))
        n = len(self._deleted_rows)
        for r in self._deleted_rows:
            self.ids.free.append(int(r))
            self.ids.row_to_ext[r] = None
        self._up_free.extend(int(s) for s in dead_slots)
        self._deleted_rows.clear()
        return n

    def _live_rows(self) -> np.ndarray:
        levels = self.state.levels[: self.ids.capacity_used].cpu().numpy()
        live = np.nonzero(levels >= 0)[0].astype(np.int32)
        if self._deleted_rows:
            live = live[~np.isin(live, np.fromiter(self._deleted_rows,
                                                   np.int32))]
        return live

    # -- query path ------------------------------------------------------------

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
        """Stage pending rows (a search sees every add) and check the
        query batch: [D] or [B, D] -> [B, D] float32."""
        self._stage_pending()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[-1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[-1]} != index dim {self.dim}")
        return queries

    def search(self, queries: np.ndarray, k: int, *,
               ef: Optional[int] = None, allow_rows=None,
               mode: Optional[str] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Batched k-NN through the fused scan: [B, D] -> (dists [B, k],
        rows [B, k]; -1 pads). `ef` is a beam parameter, unused here."""
        if (mode or self.config.serve_mode) == "beam":
            raise NotImplementedError(f"mode='beam': {GRAPH_TODO}")
        queries = self._queries(queries)
        B = queries.shape[0]
        if len(self.ids) == 0:
            return (np.full((B, k), np.inf, np.float32),
                    np.full((B, k), -1, np.int32))
        q, qn = self._encode_query(queries)
        d, rows = self._scan_search_device(q, qn, B, k,
                                           self._allow_to_device(allow_rows))
        d_np, i_np = d.cpu().numpy(), rows.cpu().numpy()
        if self._serve_quantized and self.metric == dist.L2 \
                and self.config.int8_symmetric:
            # symmetric int8 L2 scores in the quantized domain
            quantum = float(self.quantizer.abs_max) / 127.0
            d_np = d_np * (quantum * quantum)
        return d_np, i_np

    def search_device(self, queries: np.ndarray, k: int, *, allow_rows=None):
        """Scan serving with device-resident results: (d [B, k] f32,
        rows [B, k] int32, l2_rescale float), or None for an empty index."""
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
        SCAN_INTERMEDIATE_BYTES, and fetch kf >= 32 candidates."""
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
