"""Row-sharded index over a list of devices: the PyTorch port of
kektordb_tpu/parallel/sharded.py.

Rows are routed to shards by the crc32 of their id. Each shard is one of
the port's HNSWIndex objects on its own device (seed `config.seed + s`),
and a global IDMap assigns the global rows (gids) that the Engine's
filters and metadata use. One process drives every device, as the JAX
package's mesh does; there is no torch.distributed here.

A search encodes the batch once, launches every shard's local read (the
fused scan, its projected form, or the beam) on that shard's device, then
moves each shard's [B, k] tops to the first device and merges them there:
a stable sort over [B, S*k] laid out shard-major, so on equal distances
the lower shard, then the shard's own order, wins, as the reference's
`lax.top_k` merge gives it. Scores are comparable at the merge because the
int8 quantizer and the projection basis are shared across shards.

Not kept from the reference: the stacked [S, ...] serving state
(`_get_stacked`) and the capacity equalisation it needs (`_equalize_caps`).
They let XLA run one SPMD program over a mesh; eager torch launches each
shard's kernels on its own device instead, so shards keep their own
capacities and no stacked copy is built.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..index import hnsw_kernels as K
from ..index.base import IDMap
from ..index.hnsw import HNSWConfig, HNSWIndex, encode_block
from ..ops import distance as dist
from ..ops import quantize as quant

INF = float("inf")


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> list[torch.device]:
    """The first n visible devices (devlib.visible_devices): every card,
    or one device repeated by KEKTOR_TORCH_DEVICE_REPEAT."""
    devs = devlib.visible_devices(device)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f"requested {n} shards but only {len(devs)} devices are "
            f"visible (set {devlib.DEVICE_REPEAT_ENV})")
    return devs[:n]


def _route(ext_id: str) -> int:
    """Stable id -> shard hash (crc32): every process routes an id to the
    same shard, which replicated serving needs."""
    return zlib.crc32(ext_id.encode("utf-8", "surrogatepass"))


def _pad_k(d: torch.Tensor, rows: torch.Tensor, k: int):
    """[B, <=k] tops -> [B, k], padded with +inf / -1."""
    if d.shape[1] >= k:
        return d[:, :k], rows[:, :k].int()
    B, n = d.shape[0], k - d.shape[1]
    return (torch.cat([d, d.new_full((B, n), INF)], 1),
            torch.cat([rows.int(), rows.new_full((B, n), -1).int()], 1))


def merge_tops(parts: Sequence[tuple[torch.Tensor, torch.Tensor]], k: int,
               device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard (d [B, k], rows [B, k]) -> (d, shard, row) [B, k] on
    `device`: shard-major concatenation, then a stable sort, which is
    `lax.top_k(-d)` over the reference's all-gathered layout."""
    ds, ss, rs = [], [], []
    for s, (d, r) in enumerate(parts):
        d, r = _pad_k(d, r, k)
        ds.append(d.to(device))
        rs.append(r.to(device))
        ss.append(torch.full_like(rs[-1], s))
    d, pos = torch.sort(torch.cat(ds, 1), dim=1, stable=True)
    pos = pos[:, :k]
    return (d[:, :k], torch.gather(torch.cat(ss, 1), 1, pos),
            torch.gather(torch.cat(rs, 1), 1, pos))


class ShardedHNSW:
    """Row-sharded HNSW / scan index over `mesh`, a list of devices (one
    device may repeat). The Engine-facing contract is HNSWIndex's: `ids`
    is the global IDMap and `search` returns global rows."""

    def __init__(self, dim: int, metric: str = dist.L2,
                 precision: str = dist.F32,
                 config: Optional[HNSWConfig] = None,
                 mesh: Optional[Sequence] = None, *, device="cuda"):
        self.mesh = [torch.device(d) for d in
                     (mesh if mesh is not None else make_mesh(device=device))]
        self.n_shards = len(self.mesh)
        self.dim = dim
        self.metric = metric
        self.precision = precision
        self.config = config or HNSWConfig()
        self.shards = [
            HNSWIndex(dim, metric, precision,
                      dataclasses.replace(self.config,
                                          seed=self.config.seed + s),
                      device=d)
            for s, d in enumerate(self.mesh)]
        self.device = self.shards[0].device     # where tops merge
        self.ids = IDMap()                      # global ext -> gid
        self._loc_shard = np.full(4096, -1, np.int8)   # gid -> shard
        self._loc_row = np.full(4096, -1, np.int32)    # gid -> local row
        # [shard, local row] -> gid, for result translation
        self._rev = np.full((self.n_shards, 4096), -1, np.int32)
        self._rev_version = 0
        self._rev_cache: list = [None] * self.n_shards   # per-shard [cap]
        self._rev_all = None                              # [S, W] on device
        self.quantizer = self.shards[0].quantizer
        self.needs_refine = False
        self._fp_cache = None
        # serve_proj_dim: one PCA basis for every shard (host [D, p])
        self._proj_basis: Optional[torch.Tensor] = None

    @classmethod
    def from_reference_state(cls, shards: Sequence[Mapping],
                             ids: Mapping, config: HNSWConfig, *,
                             metric: str, precision: str,
                             mesh: Optional[Sequence] = None,
                             device="cuda") -> "ShardedHNSW":
        """A sharded index over states carried across from the JAX
        package's ShardedHNSW. `shards[s]`: {"arrays", "ids", "mirrors"},
        the arguments of HNSWIndex.from_reference_state for shard s (its
        config is `config` with seed + s). `ids`: the global map,
        {"row_to_ext": [...], "free": [...], "loc_shard": [...],
        "loc_row": [...]}. The reference index must be settled."""
        mesh = list(mesh) if mesh is not None \
            else make_mesh(len(shards), device)
        if len(mesh) != len(shards):
            raise ValueError(f"{len(shards)} shard states for a mesh of "
                             f"{len(mesh)} devices")
        dim = shards[0]["arrays"]["vectors"].shape[1]
        idx = cls(dim, metric, precision, config, mesh=mesh)
        idx.shards = [
            HNSWIndex.from_reference_state(
                st["arrays"], st["ids"],
                dataclasses.replace(config, seed=config.seed + s),
                metric=metric, precision=precision, device=d,
                mirrors=st.get("mirrors"))
            for s, (st, d) in enumerate(zip(shards, mesh))]
        idx._restore_ids(ids)
        return idx

    def _restore_ids(self, ids: Mapping) -> None:
        """The global IDMap and its (shard, row) maps, from host lists."""
        self.ids.row_to_ext = list(ids["row_to_ext"])
        self.ids.ext_to_row = {e: g for g, e in enumerate(self.ids.row_to_ext)
                               if e is not None}
        self.ids.free = [int(g) for g in ids.get("free", ())]
        self.ids.rebuild_mask()
        self._loc_shard = np.array(ids["loc_shard"], np.int8)
        self._loc_row = np.array(ids["loc_row"], np.int32)
        n = 4096
        while n <= int(self._loc_row.max(initial=0)):
            n *= 2
        self._rev = np.full((self.n_shards, n), -1, np.int32)
        gids = np.nonzero(self._loc_shard >= 0)[0]
        self._rev[self._loc_shard[gids], self._loc_row[gids]] = gids
        self._rev_version += 1
        self.quantizer = self.shards[0].quantizer
        self.needs_refine = any(s.needs_refine for s in self.shards)

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def deleted_count(self) -> int:
        return sum(s.deleted_count for s in self.shards)

    @property
    def _serve_quantized(self) -> bool:
        return self.shards[0]._serve_quantized

    def memory_report(self) -> dict:
        """Device bytes per shard: each holds about 1/S of the rows."""
        per = [s.memory_report() for s in self.shards]
        return {
            "shards": self.n_shards,
            "per_shard_bytes": [p["device_bytes"] for p in per],
            "device_bytes": int(sum(p["device_bytes"] for p in per)),
            "capacity_rows": int(sum(p["capacity_rows"] for p in per)),
            "rows_used": len(self.ids),
        }

    @property
    def _cap(self) -> int:
        """Global-row (gid) capacity: the Engine's masks have this size."""
        return self._loc_shard.size

    def _sync_config(self) -> None:
        """The Engine changes the serving knobs on `config`; each shard
        reads its own copy, which follows it (all but the seed)."""
        for sh in self.shards:
            for f in dataclasses.fields(HNSWConfig):
                if f.name != "seed":
                    v = getattr(self.config, f.name)
                    if getattr(sh.config, f.name) != v:
                        setattr(sh.config, f.name, v)

    def _grow_loc(self, need: int) -> None:
        if need <= self._loc_shard.size:
            return
        n = self._loc_shard.size
        while n < need:
            n *= 2
        self._loc_shard = np.concatenate(
            [self._loc_shard, np.full(n - self._loc_shard.size, -1, np.int8)])
        self._loc_row = np.concatenate(
            [self._loc_row, np.full(n - self._loc_row.size, -1, np.int32)])

    def _register(self, ext_id: str, shard: int) -> None:
        gid = self.ids.alloc(ext_id)
        self._grow_loc(gid + 1)
        row = self.shards[shard].ids.ext_to_row[ext_id]
        self._loc_shard[gid] = shard
        self._loc_row[gid] = row
        if row >= self._rev.shape[1]:
            n = self._rev.shape[1]
            while n <= row:
                n *= 2
            self._rev = np.concatenate(
                [self._rev, np.full((self.n_shards, n - self._rev.shape[1]),
                                    -1, np.int32)], axis=1)
        self._rev[shard, row] = gid
        self._rev_version += 1

    # -- gid maps on the devices ------------------------------------------

    def _rev_on(self, s: int) -> torch.Tensor:
        """[cap_s] int32 on shard s's device: the gid of each local row."""
        cap = self.shards[s]._cap
        key = (self._rev_version, cap)
        ent = self._rev_cache[s]
        if ent is not None and ent[0] == key:
            return ent[1]
        w = self._rev.shape[1]
        row = self._rev[s, :cap] if w >= cap else np.concatenate(
            [self._rev[s], np.full(cap - w, -1, np.int32)])
        t = torch.from_numpy(np.ascontiguousarray(row)).to(self.mesh[s])
        self._rev_cache[s] = (key, t)
        return t

    def _gid_device(self, sh: torch.Tensor, rows: torch.Tensor
                    ) -> torch.Tensor:
        """(shard, local row) -> gid on the merge device; -1 pads pass
        through."""
        ent = self._rev_all
        if ent is None or ent[0] != self._rev_version:
            ent = (self._rev_version,
                   torch.from_numpy(self._rev).to(self.device))
            self._rev_all = ent
        rev = ent[1]
        ok = (rows >= 0) & (rows < rev.shape[1])
        return torch.where(ok, rev[torch.where(ok, sh, 0).long(),
                                   torch.where(ok, rows, 0).long()],
                           -1).int()

    def prepare_allow(self, mask: np.ndarray) -> torch.Tensor:
        """Host bool mask over gids -> [G] bool tensor on the merge device,
        which search() takes without a transfer (the Engine caches it)."""
        return self._allow_global(mask)

    def _allow_global(self, allow_rows) -> torch.Tensor:
        """An allow argument (bool [G] over gids, or gid list) -> [G] bool
        tensor. Each shard derives its local mask from it (_local_allow)."""
        G = self._loc_shard.size
        if isinstance(allow_rows, torch.Tensor) \
                and allow_rows.dtype == torch.bool \
                and allow_rows.shape == (G,):
            return allow_rows.to(self.device)
        a = np.asarray(allow_rows)
        out = np.zeros(G, bool)
        if a.dtype == bool:
            out[: min(a.size, G)] = a[:G]
        else:
            sel = a[a >= 0].astype(np.int64)
            out[sel[sel < G]] = True
        return torch.from_numpy(out).to(self.device)

    def _local_allow(self, s: int, allow_g: torch.Tensor) -> torch.Tensor:
        """Shard s's [cap_s] allow mask: its rows' gids looked up in the
        global mask."""
        g = self._rev_on(s)
        G = allow_g.shape[0]
        a = allow_g.to(self.mesh[s])
        return (g >= 0) & (g < G) & a[g.clamp(0, G - 1).long()]

    # -- write path: hash routing, a chunked build per shard ----------------

    def add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray,
                  fast: bool = False, link: Optional[bool] = None) -> None:
        self._sync_config()
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
        buckets: list[list[int]] = [[] for _ in range(self.n_shards)]
        for j, e in enumerate(ext_ids):
            buckets[_route(e) % self.n_shards].append(j)
        if self.n_shards == 1 or len(ext_ids) < self.n_shards:
            for s, rows in enumerate(buckets):
                if rows:
                    block = [ext_ids[j] for j in rows]
                    self.shards[s].add_batch(block, vectors[rows], fast=fast,
                                             link=link)
                    for e in block:
                        self._register(e, s)
            return
        self._spmd_add_batch(ext_ids, vectors, buckets, fast, link)

    def _spmd_add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray,
                        buckets: list[list[int]], fast: bool,
                        link: Optional[bool]) -> None:
        """The reference's one-program-per-chunk build (`_spmd_insert_fn`):
        at every chunk step each shard encodes its own chunk with the
        shared quantizer and inserts it (or stages it, scan-only) on its
        own device."""
        if link is None:
            link = self.config.serve_mode != "scan"
        S = self.n_shards
        C = self.config.chunk if link else max(self.config.chunk, 4096)
        for s in self.shards:
            if link:
                s.flush()
            else:
                s._stage_pending()
        # int8 trains ONE quantizer over the incoming batch and shares it:
        # per-shard scales would make the shards' scores incommensurable
        quantized = self.precision == dist.INT8 or self._serve_quantized
        if quantized and not self.quantizer.trained:
            v = torch.from_numpy(vectors[:25000]).to(self.device)
            if self.metric == dist.COSINE:
                v = dist.normalize(v)
            self._share_quantizer(quant.train(v))

        rows_s: list[np.ndarray] = []
        lvls_s: list[np.ndarray] = []
        for s, bidx in enumerate(buckets):
            sh = self.shards[s]
            sh._grow_for(len(bidx))
            rows_s.append(np.fromiter((sh.ids.alloc(ext_ids[j]) for j in bidx),
                                      np.int32, len(bidx)))
            lvls_s.append(sh._sample_levels(len(bidx)))
        ef = max(self.config.fast_ef, 2 * self.config.m) if fast \
            else self.config.ef_construction
        steps = max((len(b) + C - 1) // C for b in buckets)
        for t in range(steps):
            for s in range(S):
                r = rows_s[s][t * C:(t + 1) * C]
                if r.size == 0:
                    continue
                lv = lvls_s[s][t * C:(t + 1) * C]
                sh = self.shards[s]
                v = torch.from_numpy(
                    vectors[buckets[s][t * C:(t + 1) * C]]).to(sh.device)
                enc, norms = encode_block(
                    v, metric=self.metric, out_dtype=sh.state.vectors.dtype,
                    quantized=quantized, quantizer=sh.quantizer)
                if link:
                    sh.state = K.insert_chunk(
                        sh.state, sh._rows(r), enc, norms, sh._rows(lv),
                        metric=self.metric, ef=ef, m=self.config.m,
                        intra_k=self.config.intra_k,
                        dual=bool(sh._deleted_rows),
                        expand=self.config.expand)
                    sh._register_upper([(int(a), int(b)) for a, b in
                                        zip(r, lv) if b >= 1])
                else:
                    sh.state = K.stage_vectors(sh.state, sh._rows(r), enc,
                                               norms, sh._rows(lv))
        for s, bidx in enumerate(buckets):
            for j in bidx:
                self._register(ext_ids[j], s)
        if link:
            if fast:
                self.needs_refine = True
                for s in self.shards:
                    s.needs_refine = True
        elif self.config.serve_mode != "scan":
            # staged-but-unlinked rows join each shard's link backlog
            for s in range(S):
                self.shards[s]._unlinked.extend(
                    zip(rows_s[s].tolist(), lvls_s[s].tolist()))

    def _share_quantizer(self, qs: quant.QuantizerState) -> None:
        self.quantizer = qs
        for s in self.shards:
            s.quantizer = quant.QuantizerState(qs.abs_max.to(s.device),
                                               qs.trained)

    def add(self, ext_id: str, vector: np.ndarray) -> None:
        if ext_id in self.ids:
            raise KeyError(f"id already present: {ext_id}")
        self._sync_config()
        s = _route(ext_id) % self.n_shards
        self.shards[s].add(ext_id, vector)
        self._register(ext_id, s)

    def delete(self, ext_id: str) -> bool:
        gid = self.ids.get(ext_id)
        if gid is None:
            return False
        s = int(self._loc_shard[gid])
        row = int(self._loc_row[gid])
        ok = self.shards[s].delete(ext_id)
        if ok:
            self.ids.release(ext_id)
            self._loc_shard[gid] = -1
            self._loc_row[gid] = -1
            if 0 <= row < self._rev.shape[1]:
                self._rev[s, row] = -1
            self._rev_version += 1
        return ok

    def get_vector(self, ext_id: str) -> Optional[np.ndarray]:
        gid = self.ids.get(ext_id)
        if gid is None:
            return None
        return self.shards[int(self._loc_shard[gid])].get_vector(ext_id)

    def flush(self) -> None:
        self._sync_config()
        for s in self.shards:
            s.flush()

    def _stage_pending(self) -> None:
        for s in self.shards:
            s._stage_pending()

    def settle_for_serving(self, mode: Optional[str] = None) -> None:
        self._sync_config()
        for s in self.shards:
            s.settle_for_serving(mode)

    def serving_dirty(self, mode: Optional[str] = None) -> bool:
        mode = mode or self.config.serve_mode
        return any(s.serving_dirty(mode) for s in self.shards)

    def state_fingerprint(self, settle: bool = True) -> dict:
        """Per-shard state checksum (crc32 of the [S, n_leaves, 2]
        sum / sum-of-squares matrix), for comparing replicas out of band.
        settle=False (the Engine's read-locked stats) never mutates: with
        pending writes it reports stale."""
        if settle:
            self.settle_for_serving()
        elif self.serving_dirty():
            return {"stale": True}
        key = tuple(s._version for s in self.shards)
        if self._fp_cache is not None and self._fp_cache[0] == key:
            return self._fp_cache[1]
        fp = self.fingerprint()
        out = {
            "crc32": zlib.crc32(
                np.ascontiguousarray(fp).tobytes()) & 0xffffffff,
            "shards": fp.shape[0],
            "per_shard_crc32": [
                zlib.crc32(np.ascontiguousarray(fp[s]).tobytes())
                & 0xffffffff for s in range(fp.shape[0])],
        }
        self._fp_cache = (key, out)
        return out

    def fingerprint(self) -> np.ndarray:
        """[S, n_leaves, 2] float32: (sum, sum of squares) of every state
        leaf of every shard, in f32; equal buffers give equal values."""
        out = []
        for s in self.shards:
            rows = []
            for leaf in s.state:
                x = leaf.float()
                rows.append(torch.stack([x.sum(), (x * x).sum()]))
            out.append(torch.stack(rows).cpu())
        return torch.stack(out).numpy().astype(np.float32)

    def run_maintenance_cycle(self) -> str:
        self._sync_config()
        return ";".join(s.run_maintenance_cycle() for s in self.shards)

    def ensure_linked(self, limit: Optional[int] = None) -> None:
        for s in self.shards:
            s.ensure_linked(limit)

    def refine_step(self) -> None:
        """One refine batch on every shard (the server's maintenance
        route)."""
        for s in self.shards:
            s.refine_step()

    def turbo_refine(self, passes: int = 1) -> None:
        self._sync_config()
        for s in self.shards:
            s.turbo_refine(passes)
        self.needs_refine = False

    def compress_serving(self, dtype: str = "bfloat16") -> None:
        """int8 trains ONE quantizer over a cross-shard sample and shares
        it: per-shard scales would make the shards' scores
        incommensurable."""
        if dtype == "int8":
            samples = []
            for s in self.shards:
                s._stage_pending()
                used = s.ids.capacity_used
                if used:
                    samples.append(
                        s.state.vectors[: min(used, 8192)].float().to(
                            self.device))
            if not samples:
                return
            self._share_quantizer(quant.train(torch.cat(samples)))
            for s in self.shards:
                s.compress_serving("int8", _pretrained=True)
            return
        for s in self.shards:
            s.compress_serving(dtype)

    def vacuum(self) -> int:
        self._sync_config()
        return sum(s.vacuum() for s in self.shards)

    def invalidate_projection(self) -> None:
        self._proj_basis = None
        for s in self.shards:
            s.invalidate_projection()

    # -- query path ----------------------------------------------------------

    def _get_proj(self):
        """The shards' projected arenas for serve_proj_dim, all under one
        PCA basis (fit on shard 0's rows, as the reference does), or None
        where the projected read does not apply."""
        p = self.config.serve_proj_dim
        s0 = self.shards[0]
        if not p or p >= self.dim or s0.state.vectors.dtype == torch.int8:
            return None
        if self._proj_basis is None or self._proj_basis.shape[1] != p:
            used = max(s0.ids.capacity_used, 1)
            sample = s0.state.vectors[:min(used, 65536)].float()
            self._proj_basis = torch.from_numpy(
                quant.fit_pca_basis(sample.cpu().numpy(), p))
            for s in self.shards:
                s.invalidate_projection()
        for s in self.shards:
            if s._proj_basis is None:
                s._proj_basis = self._proj_basis.to(s.device)
        return [s._proj_arena() for s in self.shards]

    def _queries(self, queries) -> np.ndarray:
        return self.shards[0]._queries(queries)

    def _tops(self, queries: np.ndarray, k: int, *, ef: Optional[int],
              allow_rows, use_scan: bool):
        """(d, shard, local row) [B, k] tensors on the merge device: every
        shard's local read, then the merge."""
        B = queries.shape[0]
        q, qn = self.shards[0]._encode_query(queries, use_scan)
        allow_g = None if allow_rows is None \
            else self._allow_global(allow_rows)
        if use_scan and not self.config.scan_exact:
            self._get_proj()            # share the basis before any shard
        parts = []
        for s, sh in enumerate(self.shards):
            a = None if allow_g is None else self._local_allow(s, allow_g)
            qs, qns = q.to(sh.device), qn.to(sh.device)
            if use_scan:
                parts.append(sh._scan_search_device(qs, qns, B, k, a))
            elif int(sh.state.entry) < 0:
                parts.append((torch.full((B, k), INF, device=sh.device),
                              torch.full((B, k), -1, dtype=torch.int32,
                                         device=sh.device)))
            else:
                parts.append(sh._beam_search_device(
                    qs, qns, k, max(ef or self.config.ef_search, k), a))
        return merge_tops(parts, k, self.device)

    def search(self, queries: np.ndarray, k: int, *,
               ef: Optional[int] = None, allow_rows=None,
               mode: Optional[str] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Engine-facing: (dists [B, k], global rows [B, k]; -1 pads)."""
        d, sh, rows = self._search_raw(queries, k, ef=ef,
                                       allow_rows=allow_rows, mode=mode)
        valid = (rows >= 0) & (rows < self._rev.shape[1])
        gids = np.where(valid,
                        self._rev[np.where(valid, sh, 0),
                                  np.where(valid, rows, 0)],
                        -1).astype(np.int32)
        return d, gids

    def search_device(self, queries: np.ndarray, k: int, *,
                      allow_rows=None):
        """Scan serving with results on the merge device: (d [B, k] f32,
        global rows [B, k] int32, l2 rescale), for the Engine's fused
        hybrid / decay epilogue; None in beam mode or when empty."""
        if self.config.serve_mode == "beam":
            return None
        self.settle_for_serving()
        queries = self._queries(queries)
        if len(self.ids) == 0:
            return None
        d, sh, rows = self._tops(queries, k, ef=None, allow_rows=allow_rows,
                                 use_scan=True)
        scale = 1.0
        if self._serve_quantized and self.metric == dist.L2 \
                and self.config.int8_symmetric:
            scale = (float(self.shards[0].quantizer.abs_max) / 127.0) ** 2
        return d, self._gid_device(sh, rows), scale

    def _search_raw(self, queries: np.ndarray, k: int, *,
                    ef: Optional[int] = None, allow_rows=None,
                    mode: Optional[str] = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(dists [B, k], shard [B, k], local row [B, k]) as numpy; -1
        pads."""
        use_scan = (mode or self.config.serve_mode) != "beam"
        self.settle_for_serving("scan" if use_scan else "beam")
        queries = self._queries(queries)
        B = queries.shape[0]
        if len(self.ids) == 0:
            return (np.full((B, k), np.inf, np.float32),
                    np.full((B, k), -1, np.int32),
                    np.full((B, k), -1, np.int32))
        d, sh, rows = self._tops(queries, k, ef=ef, allow_rows=allow_rows,
                                 use_scan=use_scan)
        d = d.cpu().numpy()
        if self._serve_quantized and self.metric == dist.L2 and (
                not use_scan or self.config.int8_symmetric):
            # the beam and the symmetric int8 scan score L2 in the
            # quantized domain
            quantum = float(self.shards[0].quantizer.abs_max) / 127.0
            d = d * (quantum * quantum)
        return d, sh.cpu().numpy(), rows.cpu().numpy()

    def search_ids(self, queries: np.ndarray, k: int, **kw):
        """(ext_id, dist) pairs per query."""
        d, sh, rows = self._search_raw(queries, k, **kw)
        out = []
        for b in range(rows.shape[0]):
            hits = []
            for j in range(rows.shape[1]):
                s, r = int(sh[b, j]), int(rows[b, j])
                if r >= 0:
                    ext = self.shards[s].ids.row_to_ext[r]
                    if ext is not None:
                        hits.append((ext, float(d[b, j])))
            out.append(hits)
        return out
