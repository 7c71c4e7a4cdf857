"""Exact-scan index (`kind="flat"`) and the recall oracle: the PyTorch
port of kektordb_tpu/index/bruteforce.py."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..ops import distance as dist
from ..ops import quantize as quant
from .base import IDMap


class BruteForceIndex:
    GROW = 4096      # capacity grows in fixed tiers

    def __init__(self, dim: int, metric: str = dist.L2,
                 precision: str = dist.F32, device="cuda"):
        if metric not in dist.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        if precision not in dist.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.dim = dim
        self.metric = metric
        self.precision = precision
        self.device = devlib.resolve(device)
        self.ids = IDMap()
        self._cap = self.GROW
        self._vectors = torch.zeros((self._cap, dim),
                                    dtype=dist.storage_dtype(precision),
                                    device=self.device)
        self._norms = torch.zeros((self._cap,), device=self.device)
        self._valid = np.zeros((self._cap,), bool)
        self.quantizer = quant.empty_state(self.device)

    def __len__(self) -> int:
        return len(self.ids)

    # -- mutation ------------------------------------------------------------

    def _grow_to(self, need: int) -> None:
        if need <= self._cap:
            return
        new_cap = self._cap
        while new_cap < need:
            new_cap += self.GROW
        pad = new_cap - self._cap
        self._vectors = torch.cat([self._vectors, self._vectors.new_zeros(
            (pad, self.dim))])
        self._norms = torch.cat([self._norms, self._norms.new_zeros(pad)])
        self._valid = np.pad(self._valid, (0, pad))
        self._cap = new_cap

    def _encode(self, vectors: np.ndarray):
        v = torch.from_numpy(vectors).to(self.device)
        if self.metric == dist.COSINE:
            v = dist.normalize(v)
        if self.precision == dist.INT8:
            if not self.quantizer.trained:
                self.quantizer = quant.train(v)
            return quant.quantize(self.quantizer, v)
        return v.to(dist.storage_dtype(self.precision)), None

    def add(self, ext_id: str, vector: np.ndarray) -> None:
        self.add_batch([ext_id], np.asarray(vector)[None, :])

    def add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray,
                  **_) -> None:
        """Extra kwargs (fast/link) are HNSW build hints, accepted for the
        engine's sake."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.shape != (len(ext_ids), self.dim):
            raise ValueError(
                f"expected shape ({len(ext_ids)}, {self.dim}), "
                f"got {vectors.shape}")
        rows = [self.ids.alloc(e) for e in ext_ids]
        self._grow_to(self.ids.capacity_used)
        enc, norms = self._encode(vectors)
        rows_t = torch.tensor(rows, dtype=torch.long, device=self.device)
        self._vectors[rows_t] = enc
        if norms is not None:
            self._norms[rows_t] = norms
        self._valid[rows] = True

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
        v = self._vectors[row].float().cpu().numpy()
        if self.precision == dist.INT8:
            v = v * (float(self.quantizer.abs_max) / 127.0)
        return v.astype(np.float32)

    def prepare_allow(self, mask: np.ndarray) -> torch.Tensor:
        """Host bool mask -> [cap] bool tensor on the device, reusable
        across searches (the engine's mask cache)."""
        a = np.asarray(mask, bool)
        if a.size < self._cap:
            a = np.pad(a, (0, self._cap - a.size))
        return torch.from_numpy(np.ascontiguousarray(a[: self._cap])).to(
            self.device)

    # -- query ---------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, *,
               allow_rows=None, **_) -> tuple[np.ndarray, np.ndarray]:
        """(dists [B, k] f32, rows [B, k] int32; -1 pads)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
        qn = None
        if self.metric == dist.COSINE:
            q = dist.normalize(q)
        if self.precision == dist.INT8:
            q, qn = quant.quantize(self.quantizer, q)
        valid = torch.from_numpy(self._valid).to(self.device)
        if isinstance(allow_rows, torch.Tensor) \
                and allow_rows.dtype == torch.bool \
                and allow_rows.shape == (self._cap,):
            valid = valid & allow_rows.to(self.device)
        elif allow_rows is not None:
            a = np.asarray(allow_rows, bool)[: self._cap]
            a = np.pad(a, (0, self._cap - a.size))
            valid = valid & torch.from_numpy(a).to(self.device)
        d, i = dist.brute_force_topk(
            q, self._vectors, k, self.metric, valid=valid,
            corpus_norms=self._norms if self.precision == dist.INT8
            else None,
            query_norms=qn)
        return d.cpu().numpy(), i.cpu().numpy()

    def search_ids(self, queries: np.ndarray, k: int, **kw):
        """(ext_id, dist) pairs per query."""
        d, rows = self.search(queries, k, **kw)
        return [[(self.ids.row_to_ext[r], float(d[b, j]))
                 for j, r in enumerate(rows[b]) if r >= 0]
                for b in range(rows.shape[0])]
