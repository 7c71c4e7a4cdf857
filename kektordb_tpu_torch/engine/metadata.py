"""Per-index metadata store: exact inverted index, numeric range columns,
BM25 text index, and the direct row→metadata map.

Reference (SURVEY §2.1 "Metadata indexes", core.go:903-955, 1345-1523):
  (1) inverted map[key]map[value]→roaring bitmap   → dict[key][value]→set[int]
  (2) B-tree per numeric key                       → lazily-sorted numpy column
  (3) BM25 postings per text field                 → text.bm25.BM25Index
  (4) direct metadataMap                           → dict[row]→dict

Roaring bitmaps become plain row-id sets host-side and numpy bool masks at
eval time (the device fold-in happens in the HNSW allow mask). The B-tree
becomes a sorted (values, rows) column pair rebuilt lazily — range queries are
two binary searches (np.searchsorted) instead of tree walks.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np

from kektordb_tpu.text.bm25 import BM25Index

# fields whose string value is BM25-indexed when listed here
INDEXED_FIELDS_KEY = "_indexed_fields"


def _as_number(v: Any) -> Optional[float]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


class NumericColumn:
    """Sorted-column replacement for the reference's per-key B-tree
    (core.go:949,903) — incremental like the B-tree: a sorted base plus a
    small unsorted pending overlay and a tombstone set, merged amortizedly
    (a full re-sort per write would be O(N log N) per insert at 1M rows)."""

    MERGE_PEND = 2048

    def __init__(self) -> None:
        self.values: dict[int, float] = {}
        self._base_vals = np.empty(0, np.float64)
        self._base_rows = np.empty(0, np.int64)
        self._pend: dict[int, float] = {}
        self._dead: set[int] = set()
        self._dead_arr: Optional[np.ndarray] = None

    def set(self, row: int, v: float) -> None:
        old = self.values.get(row)
        if old is not None and row not in self._pend:
            self._dead.add(row)          # stale copy lives in the base
            self._dead_arr = None
        self.values[row] = v
        self._pend[row] = v
        if len(self._pend) >= max(self.MERGE_PEND, len(self.values) // 8):
            self._merge()

    def set_batch(self, rows: Iterable[int], vals: Iterable[float]) -> None:
        for r, v in zip(rows, vals):
            old = self.values.get(r)
            if old is not None and r not in self._pend:
                self._dead.add(r)
            self.values[r] = v
            self._pend[r] = v
        self._dead_arr = None
        if len(self._pend) >= max(self.MERGE_PEND, len(self.values) // 8):
            self._merge()

    def remove(self, row: int) -> None:
        if self.values.pop(row, None) is None:
            return
        if self._pend.pop(row, None) is None:
            self._dead.add(row)
            self._dead_arr = None
        if len(self._dead) > max(1024, len(self.values) // 4):
            self._merge()

    def _merge(self) -> None:
        rows = np.fromiter(self.values.keys(), np.int64,
                           count=len(self.values))
        vals = np.fromiter(self.values.values(), np.float64,
                           count=len(self.values))
        order = np.argsort(vals, kind="stable")
        self._base_vals, self._base_rows = vals[order], rows[order]
        self._pend.clear()
        self._dead.clear()
        self._dead_arr = None

    def range_rows(self, op: str, v: float) -> np.ndarray:
        vals, rows = self._base_vals, self._base_rows
        if op == "<":
            out = rows[: np.searchsorted(vals, v, "left")]
        elif op == "<=":
            out = rows[: np.searchsorted(vals, v, "right")]
        elif op == ">":
            out = rows[np.searchsorted(vals, v, "right"):]
        elif op == ">=":
            out = rows[np.searchsorted(vals, v, "left"):]
        else:
            raise ValueError(op)
        if self._dead:
            if self._dead_arr is None:
                self._dead_arr = np.fromiter(self._dead, np.int64,
                                             count=len(self._dead))
                self._dead_arr.sort()
            out = out[~np.isin(out, self._dead_arr)]
        if self._pend:
            pr = np.fromiter(self._pend.keys(), np.int64,
                             count=len(self._pend))
            pv = np.fromiter(self._pend.values(), np.float64,
                             count=len(self._pend))
            if op == "<":
                sel = pv < v
            elif op == "<=":
                sel = pv <= v
            elif op == ">":
                sel = pv > v
            else:
                sel = pv >= v
            out = np.concatenate([out, pr[sel]])
        return out


class PostingSet(set):
    """Row set with a lazily-cached numpy array — the roaring-bitmap analog
    (core.go:944): incremental set mutation, vectorized mask materialization
    at eval time."""

    __slots__ = ("_arr",)

    def __init__(self, *a):
        super().__init__(*a)
        self._arr: Optional[np.ndarray] = None

    def add(self, x):                       # noqa: A003
        super().add(x)
        self._arr = None

    def discard(self, x):
        super().discard(x)
        self._arr = None

    def update(self, *others):
        super().update(*others)
        self._arr = None

    def rows(self) -> np.ndarray:
        if self._arr is None:
            self._arr = np.fromiter(self, np.int64, len(self))
        return self._arr


class DecayColumns:
    """Columnar mirror of the system memory fields (_created_at,
    _last_accessed, _access_count, _pinned, _memory_layer) so query-time
    decay vectorizes over the whole result batch instead of one
    h.meta.get(row) dict per hit (the reference reads node metadata per
    hit, ops.go:1100-1186 — fine at 881 QPS, not at 200k)."""

    def __init__(self) -> None:
        self.cap = 0
        self.created = np.empty(0, np.float64)      # NaN = absent
        self.accessed = np.empty(0, np.float64)
        self.count = np.empty(0, np.float32)
        self.pinned = np.empty(0, bool)
        self.layer = np.empty(0, np.int16)          # -1 = none
        self.layer_names: list[str] = []
        self._layer_ids: dict[str, int] = {}
        # bumped ONLY on decay-relevant mutations — the invalidation key
        # for the engine's device-resident decay mirror (ops/fuse.py),
        # deliberately separate from MetadataStore.version so plain
        # metadata writes don't force a [cap]-array rebuild + re-upload
        self.version = 0
        # rows holding any non-default value: makes clear_row (called per
        # metadata remove) and the no-memory-fields write path O(1) set
        # lookups instead of five numpy scalar reads per row — at 1M-row
        # bulk ingest those scalar reads are seconds
        self.touched: set[int] = set()
        # rows changed since the engine's device mirror last consumed
        # them — lets reinforce-per-read traffic update the [cap, 4]
        # mirror with a tiny scatter instead of an O(cap) rebuild
        self.dirty: set[int] = set()

    def _ensure(self, row: int) -> None:
        if row < self.cap:
            return
        new_cap = max(1024, self.cap)
        while new_cap <= row:
            new_cap *= 2
        n = new_cap - self.cap
        self.created = np.concatenate([self.created, np.full(n, np.nan)])
        self.accessed = np.concatenate([self.accessed, np.full(n, np.nan)])
        self.count = np.concatenate([self.count, np.zeros(n, np.float32)])
        self.pinned = np.concatenate([self.pinned, np.zeros(n, bool)])
        self.layer = np.concatenate(
            [self.layer, np.full(n, -1, np.int16)])
        self.cap = new_cap

    def layer_id(self, name: str) -> int:
        i = self._layer_ids.get(name)
        if i is None:
            i = len(self.layer_names)
            self.layer_names.append(name)
            self._layer_ids[name] = i
        return i

    def set_row(self, row: int, meta: dict[str, Any]) -> None:
        from . import fusion as F
        ts = F._parse_ts(meta.get(F.CREATED_KEY))
        created = np.nan if ts is None else ts
        ts = F._parse_ts(meta.get(F.ACCESSED_KEY))
        accessed = np.nan if ts is None else ts
        try:
            count = float(meta.get(F.ACCESS_COUNT_KEY) or 0.0)
        except (TypeError, ValueError):
            count = 0.0
        pinned = F._truthy(meta.get(F.PINNED_KEY))
        layer = meta.get(F.LAYER_KEY)
        lid = self.layer_id(layer) \
            if isinstance(layer, str) and layer else -1
        if np.isnan(created) and np.isnan(accessed) and count == 0.0 \
                and not pinned and lid == -1:
            self.clear_row(row)          # all defaults = same as absent
            return
        self._ensure(row)
        # bump only on a REAL change (NaN == absent): set_row runs on
        # every metadata write, and repeat writes of the same memory
        # fields must not invalidate the device decay mirror
        if row not in self.touched:
            self.touched.add(row)
            self.version += 1
            self.dirty.add(row)
        elif not (_same(self.created[row], created)
                  and _same(self.accessed[row], accessed)
                  and self.count[row] == count
                  and self.pinned[row] == pinned
                  and self.layer[row] == lid):
            self.version += 1
            self.dirty.add(row)
        self.created[row] = created
        self.accessed[row] = accessed
        self.count[row] = count
        self.pinned[row] = pinned
        self.layer[row] = lid

    def clear_row(self, row: int) -> None:
        if row not in self.touched:
            return                       # already all-default: no-op
        self.touched.discard(row)
        self.version += 1
        self.dirty.add(row)
        self.created[row] = np.nan
        self.accessed[row] = np.nan
        self.count[row] = 0.0
        self.pinned[row] = False
        self.layer[row] = -1


def _same(a: float, b: float) -> bool:
    """Float equality where NaN (= absent) equals NaN."""
    return a == b or (np.isnan(a) and np.isnan(b))


# system fields that feed DecayColumns (updated even on partial patches)
_DECAY_KEYS = ("_created_at", "_last_accessed", "_access_count",
               "_pinned", "_memory_layer")
_DECAY_KEYS_SET = frozenset(_DECAY_KEYS)


class MetadataStore:
    def __init__(self, language: str = "english"):
        self.direct: dict[int, dict[str, Any]] = {}
        self.inverted: dict[str, dict[str, PostingSet]] = {}
        self.numeric: dict[str, NumericColumn] = {}
        self.text = BM25Index(language)
        self.decay = DecayColumns()
        # bumped on every mutation — cache-invalidation key for anything
        # derived from the store (engine filter-mask cache; the roaring
        # per-(key,value) bitmaps in the reference get this for free,
        # core.go:944)
        self.version = 0

    # -- mutation (AddMetadata populates all four, core.go:1345-1523) --------

    def _index_field(self, row: int, k: str, v: Any,
                     text_fields) -> None:
        sval = v if isinstance(v, str) else _stable_str(v)
        self.inverted.setdefault(k, {}).setdefault(
            sval, PostingSet()).add(row)
        num = _as_number(v)
        if num is not None:
            self.numeric.setdefault(k, NumericColumn()).set(row, num)
        if k in text_fields and isinstance(v, str):
            self.text.add(row, k, v)

    def _unindex_field(self, row: int, k: str, v: Any) -> None:
        sval = v if isinstance(v, str) else _stable_str(v)
        vals = self.inverted.get(k)
        if vals and sval in vals:
            vals[sval].discard(row)
            if not vals[sval]:
                del vals[sval]
        col = self.numeric.get(k)
        if col:
            col.remove(row)

    @staticmethod
    def _text_fields_of(meta: dict[str, Any]):
        tf = meta.get(INDEXED_FIELDS_KEY) or []
        return [tf] if isinstance(tf, str) else tf

    def set(self, row: int, meta: dict[str, Any]) -> None:
        self.version += 1
        self.remove(row)
        self.direct[row] = dict(meta)
        text_fields = self._text_fields_of(meta)
        for k, v in meta.items():
            if k == INDEXED_FIELDS_KEY:
                continue
            self._index_field(row, k, v, text_fields)
        # remove() above already cleared the decay row (O(1) when it held
        # nothing); only rows carrying memory fields pay the parse
        if any(k in meta for k in _DECAY_KEYS):
            self.decay.set_row(row, meta)

    def set_batch(self, rows: Iterable[int],
                  metas: Iterable[Optional[dict[str, Any]]]) -> None:
        """Bulk ingest: group postings by (key, value) and insert with one
        set.update / one NumericColumn batch per group instead of per-row
        dict churn (VAddBatch per-item AddMetadata, ops.go:1384 — but
        columnar)."""
        self.version += 1
        by_kv: dict[tuple[str, str], list[int]] = {}
        num_by_k: dict[str, tuple[list[int], list[float]]] = {}
        # locals + inlined type dispatch: this loop touches every value of
        # a bulk ingest (2M+ values at the 1M-row bench) — per-value
        # helper calls (_stable_str/_as_number/_text_fields_of) and a
        # genexpr decay-key scan cost ~6s of the ~13s total (profiled)
        direct = self.direct
        text_add = self.text.add
        decay_keys = _DECAY_KEYS_SET
        for row, meta in zip(rows, metas):
            if not meta:
                continue
            if row in direct:
                self.remove(row)
            direct[row] = dict(meta)
            tf = meta.get(INDEXED_FIELDS_KEY) or ()
            text_fields = (tf,) if isinstance(tf, str) else tf
            for k, v in meta.items():
                if k == INDEXED_FIELDS_KEY:
                    continue
                tv = type(v)
                if tv is str:
                    by_kv.setdefault((k, v), []).append(row)
                    try:
                        num = float(v)
                    except ValueError:
                        num = None
                    if k in text_fields:
                        text_add(row, k, v)
                elif tv is bool:
                    by_kv.setdefault(
                        (k, "true" if v else "false"), []).append(row)
                    num = None
                elif tv is int:
                    by_kv.setdefault((k, str(v)), []).append(row)
                    num = float(v)
                elif tv is float:
                    by_kv.setdefault(
                        (k, str(int(v)) if v.is_integer() else str(v)),
                        []).append(row)
                    num = v
                else:
                    by_kv.setdefault((k, _stable_str(v)), []).append(row)
                    num = _as_number(v)
                    if isinstance(v, str) and k in text_fields:
                        text_add(row, k, v)       # str subclass
                if num is not None:
                    e = num_by_k.setdefault(k, ([], []))
                    e[0].append(row)
                    e[1].append(num)
            # rows without memory fields skip the decay parse entirely
            # (fresh rows start default; overwritten rows were cleared by
            # the remove() above)
            if not decay_keys.isdisjoint(meta):
                self.decay.set_row(row, meta)
        for (k, sval), rws in by_kv.items():
            self.inverted.setdefault(k, {}).setdefault(
                sval, PostingSet()).update(rws)
        for k, (rws, vs) in num_by_k.items():
            self.numeric.setdefault(k, NumericColumn()).set_batch(rws, vs)

    def update(self, row: int, patch: dict[str, Any]) -> None:
        """Patch-merge: re-index only the fields the patch touches
        (the reference re-runs AddMetadata wholesale; at 1M rows the
        remove+reinsert of unchanged fields dominated VMETA cost)."""
        self.version += 1
        old = self.direct.get(row)
        if old is None:
            self.set(row, patch)
            return
        if INDEXED_FIELDS_KEY in patch and \
                patch.get(INDEXED_FIELDS_KEY) != old.get(INDEXED_FIELDS_KEY):
            # text-field set changed: simplest correct path is a full reset
            merged = dict(old)
            merged.update(patch)
            self.set(row, merged)
            return
        merged = dict(old)
        merged.update(patch)
        self.direct[row] = merged
        text_fields = self._text_fields_of(merged)
        text_dirty = False
        for k, v in patch.items():
            if k == INDEXED_FIELDS_KEY:
                continue
            if k in old and old[k] == v and not isinstance(v, (list, dict)):
                continue                      # unchanged field: skip
            if k in old:
                self._unindex_field(row, k, old[k])
            if k in text_fields:
                text_dirty = True
            self._index_field(row, k, v, [])  # text handled below
        if text_dirty:
            self.text.remove(row)
            for k in text_fields:
                v = merged.get(k)
                if isinstance(v, str):
                    self.text.add(row, k, v)
        if any(k in patch for k in _DECAY_KEYS):
            self.decay.set_row(row, merged)

    def remove(self, row: int) -> None:
        self.version += 1
        old = self.direct.pop(row, None)
        if old is None:
            return
        for k, v in old.items():
            if k == INDEXED_FIELDS_KEY:
                continue
            self._unindex_field(row, k, v)
        self.text.remove(row)
        self.decay.clear_row(row)

    def get(self, row: int) -> Optional[dict[str, Any]]:
        return self.direct.get(row)

    # -- term evaluation (evaluateBooleanFilter, core.go:1786-1922) ----------

    def eval_term(self, key: str, op: str, value: str,
                  universe: Iterable[int]) -> set[int]:
        if op == "=":
            return set(self.inverted.get(key, {}).get(value, set()))
        if op == "!=":
            # "!= includes missing-field" semantics (core.go:1885-1922):
            # AndNot against the set of all valid ids
            matched = self.inverted.get(key, {}).get(value, set())
            return set(universe) - matched
        num = _as_number(value)
        if num is None:
            return set()
        col = self.numeric.get(key)
        if col is None:
            return set()
        return set(int(r) for r in col.range_rows(op, num))

    def eval_term_mask(self, key: str, op: str, value: str,
                       live: np.ndarray) -> np.ndarray:
        """Vectorized term evaluation → bool mask [cap] (the device-bitset
        analog of the reference's roaring AND/OR, SURVEY §7.1). `live` is
        the mapped-rows bitset; `!=` includes missing-field rows
        (core.go:1885-1922)."""
        cap = live.size
        mask = np.zeros(cap, bool)
        if op in ("=", "!="):
            ps = self.inverted.get(key, {}).get(value)
            if ps is not None and len(ps):
                rows = ps.rows()
                rows = rows[rows < cap]
                mask[rows] = True
            if op == "!=":
                mask = live & ~mask
            return mask
        num = _as_number(value)
        if num is None:
            return mask
        col = self.numeric.get(key)
        if col is None:
            return mask
        rows = col.range_rows(op, num)
        rows = rows[rows < cap]
        mask[rows] = True
        return mask

    def contains_rows(self, key: str, needle: str) -> set[int]:
        """CONTAINS(field,'text') substring hook (core.go:1783)."""
        needle = needle.lower()
        out = set()
        for row, meta in self.direct.items():
            v = meta.get(key)
            if isinstance(v, str) and needle in v.lower():
                out.add(row)
        return out


def _stable_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)
