"""SQL-ish filter expression → row set.

Reference: core.go:41-49 (split on OR then AND), core.go:1786-1922
(per-term operators = != < <= > >= with B-tree ranges and
"!=-includes-missing" semantics), core.go:1783 (CONTAINS hook),
core.go:1695 (FindIDsByFilter bitmap AND/OR).

Grammar:  expr   := clause (OR clause)*
          clause := term (AND term)*
          term   := key op value | CONTAINS(key, 'text')
Values may be single/double-quoted (spaces allowed) or bare tokens.
"""

from __future__ import annotations

import re
from typing import Iterable

from .metadata import MetadataStore

_OR_RE = re.compile(r"\s+OR\s+", re.IGNORECASE)
_AND_RE = re.compile(r"\s+AND\s+", re.IGNORECASE)
_TERM_RE = re.compile(
    r"^\s*([\w.\-]+)\s*(=|!=|<=|>=|<|>)\s*"
    r"(?:'([^']*)'|\"([^\"]*)\"|(\S+))\s*$")
_CONTAINS_RE = re.compile(
    r"^\s*CONTAINS\(\s*([\w.\-]+)\s*,\s*(?:'([^']*)'|\"([^\"]*)\")\s*\)\s*$",
    re.IGNORECASE)


class FilterError(ValueError):
    pass


def evaluate(expr: str, store: MetadataStore,
             universe: Iterable[int]) -> set[int]:
    """Evaluate a filter expression to the set of matching rows."""
    expr = expr.strip()
    if not expr:
        return set(universe)
    universe = set(universe)
    result: set[int] = set()
    for clause in _OR_RE.split(expr):
        acc: set[int] | None = None
        for term in _AND_RE.split(clause):
            rows = _eval_term(term, store, universe)
            acc = rows if acc is None else (acc & rows)
            if not acc:
                break
        if acc:
            result |= acc
    return result & universe


def evaluate_mask(expr: str, store: MetadataStore,
                  live: "np.ndarray") -> "np.ndarray":
    """Vectorized evaluation → bool mask [cap]. Same semantics as
    `evaluate` but no Python sets on the hot path: each term materializes a
    numpy bitset (cached posting arrays / searchsorted ranges) and clauses
    combine with & / | (FindIDsByFilter's bitmap algebra, core.go:1695)."""
    import numpy as np

    expr = expr.strip()
    if not expr:
        return live.copy()
    result = np.zeros(live.size, bool)
    for clause in _OR_RE.split(expr):
        acc = None
        for term in _AND_RE.split(clause):
            m = _CONTAINS_RE.match(term)
            if m:
                key = m.group(1)
                needle = m.group(2) if m.group(2) is not None else m.group(3)
                rows = store.contains_rows(key, needle)
                tm = np.zeros(live.size, bool)
                if rows:
                    arr = np.fromiter(rows, np.int64, len(rows))
                    tm[arr[arr < live.size]] = True
            else:
                mt = _TERM_RE.match(term)
                if not mt:
                    raise FilterError(f"cannot parse filter term: {term!r}")
                key, op = mt.group(1), mt.group(2)
                value = next(g for g in mt.groups()[2:] if g is not None)
                tm = store.eval_term_mask(key, op, value, live)
            acc = tm if acc is None else (acc & tm)
            if not acc.any():
                break
        if acc is not None:
            result |= acc
    return result & live


def _eval_term(term: str, store: MetadataStore,
               universe: set[int]) -> set[int]:
    m = _CONTAINS_RE.match(term)
    if m:
        key = m.group(1)
        needle = m.group(2) if m.group(2) is not None else m.group(3)
        return store.contains_rows(key, needle)
    m = _TERM_RE.match(term)
    if not m:
        raise FilterError(f"cannot parse filter term: {term!r}")
    key, op = m.group(1), m.group(2)
    value = next(g for g in m.groups()[2:] if g is not None)
    return store.eval_term(key, op, value, universe)
