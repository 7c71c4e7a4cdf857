"""BM25 inverted text index.

Reference: pkg/core's per-index text machinery — posting lists
map[field]map[token]{DocID,TF} + TextIndexStats{TotalDocs, AvgFieldLength,
DocLengths} (core.go:908-951), scoring k1=1.2 b=0.75 (core.go:1958-1961),
IDF log(1+(N-df+0.5)/(df+0.5)) (core.go:2044-2068).

Postings are kept host-side as dicts (the mutable source of truth —
mutation-heavy), while scoring runs on a derived CSR snapshot per field
(token → segment of parallel row/tf arrays + a dense doc-length column).
Writes that arrive after a snapshot exists land in a small DELTA (pending
postings + an override-row set) instead of invalidating it, and the
snapshot folds the delta in only once it exceeds 1/8 of the corpus — the
same incremental shape as engine.metadata.NumericColumn. Queries score
each term's snapshot segment as one numpy expression (override rows masked
via sorted lookup), score the few pending postings the same way, and
aggregate via bincount — no per-posting Python loops and no full rebuild
per interleaved write (measured: a rebuild-per-query design cost ~400 ms
per query at 200k docs; the delta path keeps steady-state scoring flat).
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from .analyzer import analyze

K1 = 1.2
B = 0.75

# fold the delta into a fresh snapshot once it covers more than
# max(_FOLD_MIN, n_docs // _FOLD_FRAC) rows
_FOLD_MIN = 1024
_FOLD_FRAC = 8


class _FieldCSR:
    """Immutable scoring snapshot of one field's postings."""

    __slots__ = ("seg", "rows", "tfs", "doc_len")

    def __init__(self, post: dict[str, dict[int, int]],
                 lens: dict[int, int]):
        nnz = sum(len(p) for p in post.values())
        self.rows = np.empty(nnz, np.int64)
        self.tfs = np.empty(nnz, np.float64)
        self.seg: dict[str, tuple[int, int]] = {}
        at = 0
        for t, plist in post.items():
            n = len(plist)
            self.rows[at:at + n] = list(plist.keys())
            self.tfs[at:at + n] = list(plist.values())
            self.seg[t] = (at, at + n)
            at += n
        max_row = int(self.rows.max()) if nnz else -1
        self.doc_len = np.zeros(max_row + 1, np.float64)
        for r, dl in lens.items():
            if r <= max_row:
                self.doc_len[r] = dl


class _Delta:
    """Writes since the snapshot: pending postings by token and by row,
    plus the set of rows whose snapshot entries are stale (overridden)."""

    __slots__ = ("post", "by_row", "rows")

    def __init__(self):
        self.post: dict[str, dict[int, int]] = {}
        self.by_row: dict[int, list[str]] = {}
        self.rows: set[int] = set()


class BM25Index:
    def __init__(self, language: str = "english"):
        self.language = language
        # field → token → {row: tf}
        self.postings: dict[str, dict[str, dict[int, int]]] = {}
        # field → {row: doc_len}
        self.doc_lengths: dict[str, dict[int, int]] = {}
        # field → running sum of doc lengths (avg_len without re-summing)
        self._len_sum: dict[str, int] = {}
        # field → derived CSR snapshot (None = stale; rebuilt on demand).
        # Concurrent readers may race to rebuild — both build, last
        # atomic assignment wins (benign; engine RW lock serializes
        # writes against reads).
        self._csr: dict[str, _FieldCSR | None] = {}
        # field → writes newer than the snapshot
        self._delta: dict[str, _Delta] = {}
        # field → row → its distinct tokens: makes remove() O(tokens of
        # the row) instead of O(vocab) (MetadataStore.remove runs per
        # set/delete — a full postings sweep per row killed update rates
        # at large vocabularies)
        self._row_tokens: dict[str, dict[int, list[str]]] = {}

    def fields(self) -> list[str]:
        return list(self.postings.keys())

    def _note_write(self, field: str, row: int,
                    tf: dict[str, int] | None) -> None:
        """Record a post-snapshot write in the delta (or fold if large)."""
        if self._csr.get(field) is None:
            self._delta.pop(field, None)
            return
        d = self._delta.setdefault(field, _Delta())
        # drop any earlier pending postings for this row (re-add/remove)
        for t in d.by_row.pop(row, ()):
            p = d.post.get(t)
            if p:
                p.pop(row, None)
                if not p:
                    del d.post[t]
        d.rows.add(row)
        if tf:
            d.by_row[row] = list(tf)
            for t, c in tf.items():
                d.post.setdefault(t, {})[row] = c
        n_docs = len(self.doc_lengths.get(field, ()))
        if len(d.rows) > max(_FOLD_MIN, n_docs // _FOLD_FRAC):
            self._csr[field] = None
            self._delta.pop(field, None)

    def _drop_postings(self, field: str, row: int) -> bool:
        """Remove row's postings for one field via the reverse map.
        Returns True if the row had postings."""
        toks = self._row_tokens.get(field, {}).pop(row, None)
        if toks is None:
            return False
        post = self.postings.get(field, {})
        for t in toks:
            p = post.get(t)
            if p is not None:
                p.pop(row, None)
                if not p:
                    del post[t]
        return True

    def add(self, row: int, field: str, text: str) -> None:
        """Upsert: re-adding a row replaces its previous postings."""
        tokens = analyze(text, self.language)
        if not tokens:
            # upsert to nothing-indexable: the row leaves the field
            self.remove(row, field)
            return
        self._drop_postings(field, row)
        post = self.postings.setdefault(field, {})
        tf: dict[str, int] = defaultdict(int)
        for t in tokens:
            tf[t] += 1
        for t, c in tf.items():
            post.setdefault(t, {})[row] = c
        self._row_tokens.setdefault(field, {})[row] = list(tf)
        lens = self.doc_lengths.setdefault(field, {})
        old = lens.get(row, 0)
        lens[row] = len(tokens)
        self._len_sum[field] = \
            self._len_sum.get(field, 0) + len(tokens) - old
        self._note_write(field, row, tf)

    def remove(self, row: int, field: str | None = None) -> None:
        fields = [field] if field else list(self.postings)
        for f in fields:
            self._drop_postings(f, row)
            old = self.doc_lengths.get(f, {}).pop(row, None)
            if old is not None:
                self._len_sum[f] = self._len_sum.get(f, 0) - old
                self._note_write(f, row, None)

    def _snapshot(self, field: str) -> _FieldCSR | None:
        csr = self._csr.get(field)
        if csr is None:
            lens = self.doc_lengths.get(field, {})
            if not lens:
                return None
            csr = _FieldCSR(self.postings.get(field, {}), lens)
            self._delta.pop(field, None)
            self._csr[field] = csr
        return csr

    def search_arrays(self, query: str, fields: list[str] | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Union-of-postings BM25 (FindIDsByTextSearch, core.go:1965-2041),
        fully vectorized: each query term's posting segment scores as one
        numpy expression (delta override rows masked, pending postings
        appended); segments aggregate with bincount.
        Returns (rows ascending int64, scores float64)."""
        tokens = analyze(query, self.language)
        row_parts: list[np.ndarray] = []
        val_parts: list[np.ndarray] = []
        for f in fields or self.fields():
            lens = self.doc_lengths.get(f)
            if not lens:
                continue
            csr = self._snapshot(f)
            if csr is None:
                continue
            n_docs = len(lens)
            avg_len = self._len_sum.get(f, 0) / n_docs
            d = self._delta.get(f)
            ov = None
            if d and d.rows:
                ov = np.fromiter(d.rows, np.int64, len(d.rows))
                ov.sort()
            post_src = self.postings.get(f, {})
            for t in tokens:
                plist = post_src.get(t)
                if not plist:
                    continue
                df = len(plist)        # true df (snapshot may be stale)
                idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                seg = csr.seg.get(t)
                if seg is not None:
                    s, e = seg
                    rows = csr.rows[s:e]
                    tfs = csr.tfs[s:e]
                    if ov is not None:
                        p = np.minimum(np.searchsorted(ov, rows),
                                       ov.size - 1)
                        keep = ov[p] != rows
                        if not keep.all():
                            rows = rows[keep]
                            tfs = tfs[keep]
                    if rows.size:
                        dl = csr.doc_len[rows]
                        denom = tfs + K1 * (1 - B + B * dl / avg_len)
                        row_parts.append(rows)
                        val_parts.append(idf * tfs * (K1 + 1) / denom)
                pend = d.post.get(t) if d else None
                if pend:
                    rows_p = np.fromiter(pend.keys(), np.int64, len(pend))
                    tfs_p = np.fromiter(pend.values(), np.float64,
                                        len(pend))
                    dl_p = np.array([lens[r] for r in rows_p.tolist()],
                                    np.float64)
                    denom = tfs_p + K1 * (1 - B + B * dl_p / avg_len)
                    row_parts.append(rows_p)
                    val_parts.append(idf * tfs_p * (K1 + 1) / denom)
        if not row_parts:
            return (np.empty(0, np.int64), np.empty(0, np.float64))
        all_rows = np.concatenate(row_parts)
        all_vals = np.concatenate(val_parts)
        if len(row_parts) == 1:
            # single segment: rows unique, but posting-dict insertion order
            # is not ascending after removes/re-adds — honor the contract
            if all_rows.size > 1 and np.any(np.diff(all_rows) < 0):
                order = np.argsort(all_rows)
                return all_rows[order], all_vals[order]
            return all_rows, all_vals
        span = int(all_rows.max()) + 1
        if all_rows.size * 8 >= span:
            # dense accumulate: O(nnz + span) beats the unique-sort
            # O(nnz log nnz) once postings cover >~1/8 of the row space
            dense = np.bincount(all_rows, weights=all_vals, minlength=span)
            uniq = np.nonzero(dense)[0]
            return uniq, dense[uniq]
        uniq, inv = np.unique(all_rows, return_inverse=True)
        return uniq, np.bincount(inv, weights=all_vals)

    def search(self, query: str, fields: list[str] | None = None
               ) -> dict[int, float]:
        """Dict view of search_arrays (unsorted; caller fuses/sorts)."""
        rows, vals = self.search_arrays(query, fields)
        return dict(zip(rows.tolist(), vals.tolist()))

    def stats(self) -> dict[str, dict[str, float]]:
        """Per-field TextIndexStats (core.go:908-951: TotalDocs,
        AvgFieldLength) plus vocab/postings sizes."""
        out: dict[str, dict[str, float]] = {}
        for f, lens in self.doc_lengths.items():
            n = len(lens)
            post = self.postings.get(f, {})
            out[f] = {
                "docs": n,
                "avg_len": (self._len_sum.get(f, 0) / n) if n else 0.0,
                "vocab": len(post),
                "postings": sum(len(p) for p in post.values()),
            }
        return out
