"""Host-RAM arena with a chunk-streamed device scan (`kind="host"`): the
PyTorch port of kektordb_tpu/index/hostarena.py.

The arena lives in host memory (pinned when the index runs on a card), so
N is bounded by host RAM, not by HBM. Each search sweeps it in chunks of
`chunk_rows` rows: a chunk is copied to the device, scanned by the entry
the resident indexes serve from (ops/scan.scan_search: pass A's kernel for
chunks of >= PALLAS_MIN_ROWS rows, the exact blocked scan below that), and
its [B, k] is folded into a running best (`merge_topk`). One fetch at the
end.

The reference gets its double buffer from JAX's dispatch-ahead. Here it is
written out (`_sweep`): a ring of at most SYNC_EVERY device chunk buffers;
a copy stream fills a slot from contiguous pinned slices once the scan
that last read the slot has recorded its event; the compute stream waits
on the slot's copy event before it scans. HBM holds a window of the arena
by construction, and the copies of the next chunks run under this chunk's
scan. Every copy is from pinned memory (a pageable source would make
`non_blocking` synchronous), so no chunk is padded or staged on the host:
capacity is a multiple of the chunk, and a chunk clipped at capacity is
passed ragged (pass A takes any N). On the CPU a chunk is a view of the
arena.

The projected mirror (proj_dim="auto" once the arena spans more than one
chunk, or an explicit p, f32 arenas only): an int8 [cap, p] PCA projection
kept beside the arena and streamed instead of it, D*bytes/p times fewer
bytes. Pass A's asymmetric fast form (f32 query x int8 codes) picks
max(proj_rerank, 2k) candidates per query; they are re-ranked exactly on
the host from the full arena.

Throughput model: a full-dimension sweep moves N*D*bytes over the
host-to-device link, amortized over the query batch.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..ops import distance as dist
from ..ops import quantize as quant
from ..ops import scan as scanops
from .base import IDMap

log = logging.getLogger(__name__)

# rows per streamed chunk: 2^18 * 128d * 4B = 128 MB f32. A multiple of
# 1024; capacity grows in chunk multiples.
CHUNK_ROWS = 1 << 18
# device chunk buffers in the ring: HBM holds at most this many chunks
SYNC_EVERY = 4


def merge_topk(best_d: torch.Tensor, best_r: torch.Tensor, d: torch.Tensor,
               r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a chunk's [B, k'] hits into the running best [B, k], ascending.
    A stable sort, as `jnp.argsort`: on equal distances the running best
    comes before the chunk, and earlier rows first."""
    both_d = torch.cat([best_d, d], 1)
    both_r = torch.cat([best_r, r], 1)
    both_d, order = torch.sort(both_d, dim=1, stable=True)
    k = best_d.shape[1]
    return both_d[:, :k], torch.gather(both_r, 1, order[:, :k])


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array (bf16 from ml_dtypes crosses as its uint16 bits) or a
    tensor -> a CPU tensor of `dtype`."""
    if isinstance(a, torch.Tensor):
        return a.to("cpu", dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dtype)
    return torch.from_numpy(np.array(a)).to(dtype)


class HostArenaIndex:
    """BruteForceIndex-compatible surface over a host-RAM arena
    (kind="host" through the Engine)."""

    def __init__(self, dim: int, metric: str = dist.L2,
                 precision: str = dist.F32, chunk_rows: int = CHUNK_ROWS,
                 proj_dim: "int | str" = "auto", proj_rerank: int = 128,
                 device="cuda"):
        if metric not in dist.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        if precision not in dist.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if chunk_rows % 1024:
            raise ValueError("chunk_rows must be a multiple of 1024")
        self.dim = dim
        self.metric = metric
        self.precision = precision
        self.chunk_rows = chunk_rows
        self.device = devlib.resolve(device)
        # pinned host memory feeds the card's copy engine asynchronously
        self._pin = self.device.type == "cuda"
        self.ids = IDMap()
        self._cap = 0
        self._store_dtype = dist.storage_dtype(precision)
        self._vectors = self._host_zeros((0, dim), self._store_dtype)
        self._norms = self._host_zeros((0,), torch.float32)
        self._valid = np.zeros((0,), bool)
        self.quantizer = quant.empty_state()
        # proj_dim="auto" (the default): the mirror switches on by itself
        # once the arena outgrows one streamed chunk; 0 forces the
        # full-dimension sweep; > 0 pins an explicit p (f32 arenas only)
        self._proj_auto = proj_dim == "auto" or \
            (isinstance(proj_dim, int) and proj_dim < 0)
        if self._proj_auto or precision != dist.F32:
            self.proj_dim = 0
        else:
            self.proj_dim = int(proj_dim)
        self.proj_rerank = proj_rerank
        self._proj_basis: Optional[np.ndarray] = None    # [D, p] f32
        self._proj_vecs: Optional[torch.Tensor] = None   # [cap, p] int8
        self._proj_norms = self._host_zeros((0,), torch.float32)
        self._proj_quant: Optional[quant.QuantizerState] = None
        self._proj_fit_lock = threading.Lock()           # search-path fit
        # seconds spent allocating (pinning) and copying on growth
        self.grow_seconds = 0.0
        # what the last search streamed and how long it and its parts took
        # (`trace` = True adds device times from CUDA events)
        self.trace = False
        self.last_sweep: dict[str, Any] = {}

    @classmethod
    def from_reference_state(cls, st: Mapping[str, Any],
                             arrays: Mapping[str, Any], device="cuda"
                             ) -> "HostArenaIndex":
        """The index that the JAX package's `index_io.dump_index` described
        for a host index: `st` is its state dict, `arrays` its "vectors",
        "norms" and "valid" leaves (numpy arrays or tensors)."""
        idx = cls(st["dim"], st["metric"], st["precision"],
                  proj_dim="auto" if st.get("proj_auto")
                  else int(st.get("proj_dim", 0)),
                  proj_rerank=int(st.get("proj_rerank", 128)),
                  device=device)
        vecs = _host_tensor(arrays["vectors"], idx._store_dtype)
        idx._cap = vecs.shape[0]
        idx._vectors = idx._host_zeros(tuple(vecs.shape), idx._store_dtype)
        idx._vectors.copy_(vecs)
        idx._norms = idx._host_zeros((idx._cap,), torch.float32)
        idx._norms.copy_(_host_tensor(arrays["norms"], torch.float32))
        valid = arrays["valid"]
        idx._valid = (valid.numpy() if isinstance(valid, torch.Tensor)
                      else np.asarray(valid)).astype(bool)
        idx.ids.ext_to_row = dict(st["ext_to_row"])
        idx.ids.row_to_ext = [None] * st["rows"]
        for e, r in idx.ids.ext_to_row.items():
            idx.ids.row_to_ext[r] = e
        idx.ids.free = list(st["free"])
        idx.ids.rebuild_mask()
        q = st["quantizer"]
        idx.quantizer = quant.QuantizerState(
            torch.tensor(float(q["abs_max"])), bool(q["trained"]))
        return idx

    def __len__(self) -> int:
        return len(self.ids)

    def _host_zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    def memory_report(self) -> dict:
        """Host-RAM accounting: the arena lives on the host; the device
        holds at most SYNC_EVERY chunks during a sweep."""
        host = int(self._vectors.nbytes + self._norms.nbytes
                   + self._valid.nbytes + self._proj_norms.nbytes
                   + (self._proj_vecs.nbytes
                      if self._proj_vecs is not None else 0))
        return {
            "host_bytes": host,
            "device_bytes": int(
                min(self.chunk_rows, self._cap)
                * self.dim * self._store_dtype.itemsize),
            "capacity_rows": int(self._cap),
            "rows_used": len(self.ids),
        }

    # -- mutation ----------------------------------------------------------

    def _regrow(self, t: torch.Tensor, cap: int) -> torch.Tensor:
        new = torch.empty((cap, *t.shape[1:]), dtype=t.dtype,
                          pin_memory=self._pin)
        new[: t.shape[0]].copy_(t)
        new[t.shape[0]:].zero_()
        return new

    def _grow_to(self, need: int) -> None:
        """Geometric growth in chunk multiples: amortized O(N) copies. Each
        step allocates new (pinned) buffers and copies into them; pinning
        takes seconds per few GB, so the time is kept in `grow_seconds`
        and logged."""
        if need <= self._cap:
            return
        new_cap = max(self._cap, self.chunk_rows)
        while new_cap < need:
            new_cap *= 2
        t0 = time.perf_counter()
        self._vectors = self._regrow(self._vectors, new_cap)
        self._norms = self._regrow(self._norms, new_cap)
        self._valid = np.concatenate(
            [self._valid, np.zeros(new_cap - self._cap, bool)])
        if self._proj_vecs is not None:
            self._proj_vecs = self._regrow(self._proj_vecs, new_cap)
            self._proj_norms = self._regrow(self._proj_norms, new_cap)
        self._cap = new_cap
        dt = time.perf_counter() - t0
        self.grow_seconds += dt
        log.info("host arena grown to %d rows (%.1f MB%s) in %.3f s",
                 new_cap, self._vectors.nbytes / 1e6,
                 ", pinned" if self._pin else "", dt)

    def _encode(self, vectors: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(codes, norms) on the host: norms are |x|^2 for float L2 (the
        scan's bias form), int-domain norms for int8, zeros for cosine."""
        v = np.asarray(vectors, np.float32)
        if self.metric == dist.COSINE:
            v = v / np.maximum(
                np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        if self.precision == dist.INT8:
            vt = torch.from_numpy(np.ascontiguousarray(v))
            if not self.quantizer.trained:
                self.quantizer = quant.train(vt)
            return quant.quantize(self.quantizer, vt)
        if self.metric == dist.COSINE:
            norms = np.zeros(v.shape[0], np.float32)
        else:
            norms = np.einsum("nd,nd->n", v, v).astype(np.float32)
        return (torch.from_numpy(np.ascontiguousarray(v)).to(
            self._store_dtype), torch.from_numpy(norms))

    def add(self, ext_id: str, vector: np.ndarray) -> None:
        self.add_batch([ext_id], np.asarray(vector)[None, :])

    def add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray,
                  **_) -> None:
        vectors = np.asarray(vectors, np.float32)
        if vectors.shape != (len(ext_ids), self.dim):
            raise ValueError(
                f"expected shape ({len(ext_ids)}, {self.dim}), "
                f"got {vectors.shape}")
        rows = np.array([self.ids.alloc(e) for e in ext_ids], np.int64)
        self._grow_to(self.ids.capacity_used)
        codes, norms = self._encode(vectors)
        rt = torch.from_numpy(rows)
        self._vectors[rt] = codes
        self._norms[rt] = norms
        self._valid[rows] = True
        if self.proj_dim:
            self._project_rows(rows)   # guards applicability itself

    def _project_rows(self, rows: np.ndarray) -> None:
        """Keep the int8 projected mirror in sync: new rows are projected
        with the standing basis; the basis is fit once, centered, from the
        first live rows (at most 65,536).

        The first fit can run on the search path, which the engine serves
        under the shared side of its lock: the whole mirror is built into
        locals and `_proj_basis` is published last, so a concurrent reader
        sees either no mirror (full-dimension sweep) or a complete one."""
        p = self.proj_dim
        if not (0 < p < self.dim) or self.precision != dist.F32:
            return                          # projection not applicable
        if self._proj_basis is None:
            live = np.nonzero(self._valid)[0]
            if live.size < max(4 * p, 64):
                return                      # fit later, on first search
            sample = self._vectors[torch.from_numpy(live[:65536])].numpy()
            basis = quant.fit_pca_basis(sample, p)
            pq = quant.train(torch.from_numpy(
                np.ascontiguousarray((sample @ basis).reshape(-1, p))))
            vecs = self._host_zeros((self._cap, p), torch.int8)
            nrms = self._host_zeros((self._cap,), torch.float32)
            for i in range(0, live.size, 1 << 20):
                rr = live[i:i + (1 << 20)]
                self._project_into(vecs, nrms, rr, basis, pq)
            self._proj_quant = pq
            self._proj_vecs = vecs
            self._proj_norms = nrms
            self._proj_basis = basis        # publish gate, set last
            return
        for i in range(0, rows.size, 1 << 20):   # bound the f32 cast
            self._project_into(self._proj_vecs, self._proj_norms,
                               rows[i:i + (1 << 20)], self._proj_basis,
                               self._proj_quant)

    def _project_into(self, vecs: torch.Tensor, nrms: torch.Tensor,
                      rows: np.ndarray, basis: np.ndarray,
                      pq: quant.QuantizerState) -> None:
        rt = torch.from_numpy(rows)
        pa = self._vectors[rt].numpy() @ basis
        codes, nrm = quant.quantize(pq, torch.from_numpy(pa))
        vecs[rt] = codes
        nrms[rt] = nrm

    def reset_projection(self, proj_dim: Optional[int] = None) -> None:
        """Drop the mirror (refit at the next search). An explicit
        `proj_dim` pins p (f32 arenas only) and turns "auto" off."""
        if proj_dim is not None:
            self.proj_dim = max(0, int(proj_dim)) \
                if self.precision == dist.F32 else 0
            self._proj_auto = False
        self._proj_basis = None
        self._proj_vecs = None
        self._proj_norms = self._host_zeros((0,), torch.float32)
        self._proj_quant = None

    def delete(self, ext_id: str) -> bool:
        if ext_id not in self.ids:
            return False
        row = self.ids.release(ext_id)
        self._valid[row] = False
        return True

    def get_vector(self, ext_id: str) -> Optional[np.ndarray]:
        row = self.ids.get(ext_id)
        if row is None:
            return None
        v = self._vectors[row].float().numpy()
        if self.precision == dist.INT8:
            v = v * (float(self.quantizer.abs_max) / 127.0)
        return v.astype(np.float32)

    # -- query -------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, *,
               allow_rows: Optional[np.ndarray] = None, **_
               ) -> tuple[np.ndarray, np.ndarray]:
        """Chunk-streamed sweep: (dists [B, k] f32, rows [B, k]; -1 pads).
        Any B: the batch is not padded."""
        t0 = time.perf_counter()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        B = queries.shape[0]
        if self._cap == 0 or not self._valid.any():
            return (np.full((B, k), np.inf, np.float32),
                    np.full((B, k), -1, np.int64))
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
        if self.metric == dist.COSINE:
            q = dist.normalize(q)
        qn = torch.zeros(B, device=self.device)
        if self.precision == dist.INT8:
            q, qn = quant.quantize(self.quantizer, q)
        live = self._valid.copy()
        if allow_rows is not None:
            allow = np.zeros(self._cap, bool)
            a = np.asarray(allow_rows)
            if a.dtype == bool:
                allow[: min(a.size, self._cap)] = a[: self._cap]
            else:
                # the -1 missing-id sentinel must not wrap to the tail
                allow[a[(a >= 0) & (a < self._cap)]] = True
            live &= allow

        self._maybe_auto_proj()
        if self.proj_dim and self._proj_basis is None:
            # fit on demand; concurrent searches serialize the fit, and the
            # losers of the race then see the published mirror
            with self._proj_fit_lock:
                if self._proj_basis is None:
                    self._project_rows(np.empty(0, np.int64))
        if self._proj_basis is not None and self.precision == dist.F32:
            out = self._search_projected(q, B, k, live)
        else:
            out = self._search_fulldim(q, qn, B, k, live)
        self.last_sweep["search_s"] = time.perf_counter() - t0
        return out

    def _maybe_auto_proj(self) -> None:
        """Resolve proj_dim="auto": switch the projected mirror on (p=32)
        once the arena spans more than one streamed chunk; dimensions
        below 64 keep the full sweep (the saving no longer covers the
        re-rank)."""
        if not self._proj_auto or self.proj_dim or \
                self.precision != dist.F32 or self.dim < 64:
            return
        if self._cap > self.chunk_rows:
            self.proj_dim = 32
            log.info("host arena %dd x %d rows: auto-enabling the projected "
                     "mirror (p=32, rerank=%d); set proj_dim=0 to force the "
                     "full-dimension sweep", self.dim,
                     int(self._valid.sum()), self.proj_rerank)

    def _sweep(self, vecs: torch.Tensor, norms: torch.Tensor,
               live: np.ndarray, C: int, q: torch.Tensor, qn: torch.Tensor,
               k: int, **scan_kw) -> tuple[torch.Tensor, torch.Tensor]:
        """Scan every chunk of C rows of the host arrays (vecs [cap, W],
        norms [cap]) that holds a live row, and merge: the running best
        (d [B, k] f32, rows [B, k] int32) on the device."""
        cap = vecs.shape[0]
        dev = self.device
        B = q.shape[0]
        bases = [b for b in range(0, cap, C) if live[b:b + C].any()]
        best_d = torch.full((B, k), scanops.INF, device=dev)
        best_r = torch.full((B, k), -1, dtype=torch.int32, device=dev)
        live_h = torch.empty(cap, dtype=torch.bool, pin_memory=self._pin)
        live_h.copy_(torch.from_numpy(live))
        lev0 = torch.zeros(C, dtype=torch.int32, device=dev)
        del0 = torch.zeros(C, dtype=torch.bool, device=dev)
        row_bytes = vecs.shape[1] * vecs.element_size() + 4 + 1
        sweep = {"chunks": len(bases), "chunk_rows": C,
                 "bytes": sum(min(C, cap - b) for b in bases) * row_bytes}
        self.last_sweep = sweep

        def scan(i, v, n, lv):
            d, r = scanops.scan_search(
                v, n, lev0[: v.shape[0]], del0[: v.shape[0]], lv, q, qn, k,
                metric=self.metric, **scan_kw)
            return d, torch.where(r >= 0, r + bases[i], r).int()

        if dev.type != "cuda":
            for i, b in enumerate(bases):
                e = min(b + C, cap)
                d, r = scan(i, vecs[b:e], norms[b:e], live_h[b:e])
                best_d, best_r = merge_topk(best_d, best_r, d, r)
            return best_d, best_r

        R = min(SYNC_EVERY, len(bases))
        compute = torch.cuda.current_stream(dev)
        copier = torch.cuda.Stream(dev)
        copier.wait_stream(compute)     # the ring's memory may be reused
        ring = [(torch.empty((C, vecs.shape[1]), dtype=vecs.dtype,
                             device=dev),
                 torch.empty(C, dtype=torch.float32, device=dev),
                 torch.empty(C, dtype=torch.bool, device=dev))
                for _ in range(R)]
        copied = [torch.cuda.Event() for _ in range(R)]
        freed = [torch.cuda.Event() for _ in range(R)]
        trace = [] if self.trace else None

        def timed_event(stream):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            return ev

        def issue(i):
            s, b = i % R, bases[i]
            n = min(C, cap - b)
            with torch.cuda.stream(copier):
                if i >= R:              # the slot's last reader is done
                    copier.wait_event(freed[s])
                t0 = timed_event(copier) if trace is not None else None
                for dst, src in zip(ring[s], (vecs, norms, live_h)):
                    dst[:n].copy_(src[b:b + n], non_blocking=True)
                copied[s].record(copier)
                if trace is not None:
                    trace.append(("copy", t0, timed_event(copier)))

        for i in range(R):
            issue(i)
        for i, b in enumerate(bases):
            s, n = i % R, min(C, cap - b)
            compute.wait_event(copied[s])
            t0 = timed_event(compute) if trace is not None else None
            v, nr, lv = (t[:n] for t in ring[s])
            d, r = scan(i, v, nr, lv)
            freed[s].record(compute)
            t1 = timed_event(compute) if trace is not None else None
            best_d, best_r = merge_topk(best_d, best_r, d, r)
            if trace is not None:
                trace.append(("scan", t0, t1))
                trace.append(("merge", t1, timed_event(compute)))
            if i + R < len(bases):
                issue(i + R)
        if trace is not None:
            torch.cuda.synchronize(dev)
            parts = {"copy": 0.0, "scan": 0.0, "merge": 0.0}
            for name, a, z in trace:
                parts[name] += a.elapsed_time(z)
            sweep.update({f"{k}_ms": v for k, v in parts.items()})
            sweep["wall_ms"] = trace[0][1].elapsed_time(trace[-1][2])
        return best_d, best_r

    def _search_fulldim(self, q, qn, B: int, k: int, live: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        best_d, best_r = self._sweep(self._vectors, self._norms, live,
                                     self.chunk_rows, q, qn, k,
                                     mode="approx")
        d = best_d.cpu().numpy()
        r = best_r.cpu().numpy().astype(np.int64)
        if self.precision == dist.INT8 and self.metric == dist.L2:
            # int8 L2 runs in the quantized domain: back to the real one
            # (cosine is scale-invariant)
            quantum = float(self.quantizer.abs_max) / 127.0
            d = d * (quantum * quantum)
        r[~np.isfinite(d)] = -1
        return d, r

    def _search_projected(self, q: torch.Tensor, B: int, k: int,
                          live: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Projected sweep over the int8 mirror, then the exact
        full-dimension re-rank of the candidates on the host."""
        # chunks sized by bytes: chunk_rows bounds a full-dimension chunk
        # at D * itemsize * rows bytes; the mirror's rows are p bytes, so
        # the same budget covers D * itemsize / p times more rows. Pass
        # B's [B, Cn/G] f32 + int32 intermediates stay under 1 GiB.
        row_full = self.dim * self._store_dtype.itemsize
        row_proj = max(self.proj_dim * self._proj_vecs.element_size(), 1)
        Cn = self.chunk_rows * max(1, row_full // row_proj)
        inter_bound = (1 << 30) // max(B * 8, 1)     # rows/G per query
        Cn = min(Cn, inter_bound * scanops.g_for(Cn))
        Cn = min(Cn, -(-self._cap // 1024) * 1024)
        Cn = max(self.chunk_rows, (Cn // 1024) * 1024)
        Cc = max(self.proj_rerank, 2 * k)
        # at most the chunk scan's pass-B width (its G-group minima)
        Cc = min(Cc, Cn // scanops.g_for(Cn))
        basis = torch.from_numpy(self._proj_basis).to(self.device)
        qp = q.float() @ basis
        # the mirror scores asymmetrically (f32 projected query x int8
        # codes); quantum puts the L2 bias in the dequantized domain
        # (cosine is scale-invariant). fast=True: rank only, the exact
        # re-rank below reads the full arena.
        quantum = None
        if self.metric == dist.L2 and self._proj_quant is not None:
            quantum = (self._proj_quant.abs_max / 127.0).to(self.device)
        _, best_r = self._sweep(self._proj_vecs, self._proj_norms, live, Cn,
                                qp, torch.zeros(B, device=self.device), Cc,
                                mode="approx", fast=True, quantum=quantum)
        rows = best_r.cpu().long()                            # [B, Cc]
        t0 = time.perf_counter()
        qf = q.float().cpu()
        safe = torch.clamp_min(rows, 0)
        cand = self._vectors.index_select(0, safe.reshape(-1)).view(
            B, -1, self.dim).float()                          # [B, Cc, D]
        dots = torch.bmm(cand, qf[:, :, None])[..., 0]
        if self.metric == dist.COSINE:
            d = 1.0 - dots
        else:
            d = self._norms[safe] - 2.0 * dots \
                + torch.sum(qf * qf, dim=1, keepdim=True)
        d = torch.where(rows < 0, scanops.INF, d)
        d, order = torch.sort(d, dim=1, stable=True)
        d, rows = d[:, :k], torch.gather(rows, 1, order[:, :k])
        rows = torch.where(torch.isfinite(d), rows, -1)
        self.last_sweep["rerank_s"] = time.perf_counter() - t0
        self.last_sweep["rerank_bytes"] = cand.numel() * 4
        return torch.clamp_min(d, 0.0).numpy(), rows.numpy()

    def search_ids(self, queries: np.ndarray, k: int, **kw):
        d, rows = self.search(queries, k, **kw)
        return [[(self.ids.row_to_ext[r], float(d[b, j]))
                 for j, r in enumerate(rows[b]) if r >= 0]
                for b in range(rows.shape[0])]
