"""VectorIndex protocol + the host-side ID map shared by all index kinds.

Reference: pkg/core/vector_index.go:26-46 defines the VectorIndex interface
(Add/AddBatch/Search/SearchWithScores/Delete/Dimensions/Len/...). The rebuild
keeps the same surface but batch-first: `search` takes [B, D] and returns
[B, k] — single queries are a B=1 special case.

String external IDs ↔ int32 device rows live host-side exactly as the
reference keeps its ext↔int maps outside the hot loop (hnsw_index.go:74-75).
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np


class IDMap:
    """ext string id ↔ int row, with a LIFO free list (arena slot reuse,
    pkg/storage/mmap/arena.go:121-170)."""

    def __init__(self) -> None:
        self.ext_to_row: dict[str, int] = {}
        self.row_to_ext: list[str | None] = []
        self.free: list[int] = []
        # bumped on every mapping mutation — cache-invalidation key for
        # anything derived from the live set (engine filter-mask cache)
        self.version = 0
        self._mask = np.zeros(1024, bool)   # live-row bitset (roaring analog)
        # object-dtype mirror of row_to_ext for vectorized fancy-index id
        # lookup on the serving path; kept fresh incrementally by
        # alloc/release/unmap, rebuilt on wholesale list replacement
        # (detected via `is` against the retained source reference)
        self._ext_cache: np.ndarray | None = None
        self._ext_cache_list: list | None = None

    def __len__(self) -> int:
        return len(self.ext_to_row)

    def __contains__(self, ext: str) -> bool:
        return ext in self.ext_to_row

    def get(self, ext: str) -> int | None:
        return self.ext_to_row.get(ext)

    def _mask_set(self, row: int, val: bool) -> None:
        if row >= self._mask.size:
            n = self._mask.size
            while n <= row:
                n *= 2
            self._mask = np.concatenate(
                [self._mask, np.zeros(n - self._mask.size, bool)])
        self._mask[row] = val

    def _ext_cache_set(self, row: int, val: str | None) -> None:
        c = self._ext_cache
        if c is not None:
            if row >= c.size:               # geometric growth, like _mask_set
                n = c.size
                while n <= row:
                    n *= 2
                nc = np.empty(n, object)
                nc[:c.size] = c
                self._ext_cache = c = nc
            c[row] = val

    def exts_array(self) -> np.ndarray:
        """Object-dtype [>= len(row_to_ext)] mirror for vectorized
        `arr[rows]` id lookup (the serving-path replacement for a Python
        loop over row_to_ext). O(rows) rebuild only after wholesale map
        replacement; incremental updates keep it fresh otherwise."""
        n = len(self.row_to_ext)
        c = self._ext_cache
        if c is None or self._ext_cache_list is not self.row_to_ext \
                or c.size < n:
            size = 1024
            while size < n:
                size *= 2               # headroom so appends stay in place
            c = np.empty(size, object)
            if n:
                c[:n] = self.row_to_ext
            self._ext_cache = c
            self._ext_cache_list = self.row_to_ext
        return c

    def live_mask(self, cap: int) -> np.ndarray:
        """Bool [cap] of mapped rows — the vectorized `universe` for filter
        evaluation (replaces building a Python set per request)."""
        if self._mask.size < cap:
            self._mask_set(cap - 1, False)
        return self._mask[:cap]

    def alloc(self, ext: str) -> int:
        if ext in self.ext_to_row:
            raise KeyError(f"id already present: {ext}")
        row = self.free.pop() if self.free else len(self.row_to_ext)
        if row == len(self.row_to_ext):
            self.row_to_ext.append(ext)
        else:
            self.row_to_ext[row] = ext
        self.ext_to_row[ext] = row
        self.version += 1
        self._mask_set(row, True)
        self._ext_cache_set(row, ext)
        return row

    def release(self, ext: str) -> int:
        row = self.ext_to_row.pop(ext)
        self.row_to_ext[row] = None
        self.free.append(row)
        self.version += 1
        self._mask_set(row, False)
        self._ext_cache_set(row, None)
        return row

    def unmap(self, ext: str) -> int:
        """Remove the mapping without freeing the row (soft delete: the row
        still exists on device until vacuum reclaims it)."""
        row = self.ext_to_row.pop(ext)
        self.row_to_ext[row] = None
        self.version += 1
        self._mask_set(row, False)
        self._ext_cache_set(row, None)
        return row

    def rebuild_mask(self) -> None:
        """Recompute the live bitset after bulk-restoring the dicts
        (checkpoint load paths assign ext_to_row directly)."""
        n = 1024
        while n < max(len(self.row_to_ext), 1):
            n *= 2
        m = np.zeros(n, bool)
        if self.ext_to_row:
            m[np.fromiter(self.ext_to_row.values(), np.int64,
                          len(self.ext_to_row))] = True
        self._mask = m
        self._ext_cache = None
        self.version += 1

    def rows_of(self, exts: Sequence[str]) -> np.ndarray:
        return np.array([self.ext_to_row.get(e, -1) for e in exts], dtype=np.int32)

    def exts_of(self, rows: Sequence[int]) -> list[str | None]:
        out = []
        for r in rows:
            out.append(self.row_to_ext[r] if 0 <= r < len(self.row_to_ext) else None)
        return out

    @property
    def capacity_used(self) -> int:
        return len(self.row_to_ext)


class VectorIndex(Protocol):
    dim: int
    metric: str
    precision: str

    def __len__(self) -> int: ...
    def add(self, ext_id: str, vector: np.ndarray) -> None: ...
    def add_batch(self, ext_ids: Sequence[str], vectors: np.ndarray) -> None: ...
    def delete(self, ext_id: str) -> bool: ...
    def search(self, queries: np.ndarray, k: int, **kw) -> tuple[np.ndarray, np.ndarray]: ...
