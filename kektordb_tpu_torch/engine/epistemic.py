"""Epistemic engine — belief-state assessment for stored memories.

Reference: pkg/engine/epistemic_types.go + epistemic.go. A node's belief
score is a weighted blend (epistemic_types.go:126-254):

  consensus 40%  — how tightly the node's semantic neighborhood clusters
                   (vector variance around the neighborhood centroid)
  stability 30%  — age + access reinforcement under the decay model
  friction  30%  — contradicts/invalidates incoming edges push against it

State thresholds (epistemic_types.go:256-275): crystallized >= 0.85,
volatile <= 0.40, contested when friction edges exist, else forming.
The caveat generator (epistemic_types.go:277) is provided in English and
Italian like the reference.

All of this is plain vectorized math over arrays the engine already holds —
the "trivially vectorizable" service of SURVEY §7.3 M7.

The port's copy of kektordb_tpu/engine/epistemic.py: it reads the arena's
rows from the index's tensors (`_rows_f32`) where the reference reads a
JAX array.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from . import fusion

W_CONSENSUS, W_STABILITY, W_FRICTION = 0.40, 0.30, 0.30
CRYSTALLIZED_MIN = 0.85
VOLATILE_MAX = 0.40
FRICTION_RELATIONS = ("contradicts", "invalidates")


@dataclass
class BeliefState:
    node: str
    score: float
    state: str                    # crystallized | contested | volatile | forming
    consensus: float
    stability: float
    friction: float
    friction_count: int
    neighbors: list[str]
    caveat: str


def assess(engine, index: str, node_id: str, *, k: int = 10,
           language: str = "english",
           now: Optional[float] = None) -> BeliefState:
    """VBeliefState (epistemic.go:22-183): search → score pipeline."""
    h = engine._handle(index)
    idx = h.index
    if hasattr(idx, "flush"):
        idx.flush()
    row = idx.ids.get(node_id)
    if row is None:
        raise KeyError(f"no such id: {node_id}")
    now = now if now is not None else time.time()

    vec = _rows_f32(idx, row)
    hits = engine.search(index, vec, k=k + 1)[0]
    neigh = [hh for hh in hits if hh["id"] != node_id][:k]

    consensus = _consensus(idx, [idx.ids.get(hh["id"]) for hh in neigh], vec)
    stability = _stability(h.meta.get(row) or {}, h.memory, now)
    fcount = sum(
        1 for rel, _ in engine.graph.in_edges(f"{index}/{node_id}")
        if rel in FRICTION_RELATIONS)
    friction = 1.0 - 1.0 / (1.0 + fcount)      # 0 → no pushback

    score = (W_CONSENSUS * consensus + W_STABILITY * stability
             + W_FRICTION * (1.0 - friction))
    if score >= CRYSTALLIZED_MIN:
        state = "crystallized"
    elif score <= VOLATILE_MAX:
        state = "volatile"
    elif fcount > 0:
        state = "contested"
    else:
        state = "forming"
    return BeliefState(
        node=node_id, score=round(float(score), 4), state=state,
        consensus=round(consensus, 4), stability=round(stability, 4),
        friction=round(friction, 4), friction_count=fcount,
        neighbors=[hh["id"] for hh in neigh],
        caveat=_caveat(state, language))


def _consensus(idx, rows: list[Optional[int]], vec: np.ndarray) -> float:
    """Inverse normalized variance of the neighborhood around its centroid
    (epistemic_types.go:126-180)."""
    rows = [r for r in rows if r is not None]
    if len(rows) < 2:
        return 0.5
    nb = _rows_f32(idx, rows)
    centroid = nb.mean(axis=0)
    scale = float(np.mean(np.sum((nb - vec) ** 2, axis=1))) + 1e-9
    var = float(np.mean(np.sum((nb - centroid) ** 2, axis=1)))
    return 1.0 / (1.0 + var / scale)


def _rows_f32(idx, rows) -> np.ndarray:
    """Stored arena rows as float32 numpy (a row index or a list)."""
    return idx.state.vectors[rows].float().cpu().numpy()


def _stability(meta: dict[str, Any], memory: fusion.MemoryConfig,
               now: float) -> float:
    """Age + access reinforcement (epistemic_types.go:182-226): memories
    gain stability as they age without decaying and as they are accessed."""
    created = fusion._parse_ts(meta.get(fusion.CREATED_KEY))
    if created is None:
        return 0.5
    age_days = max(now - created, 0.0) / 86400.0
    age_part = min(math.log1p(age_days) / math.log1p(365.0), 1.0)
    access = float(meta.get(fusion.ACCESS_COUNT_KEY) or 0.0)
    access_part = min(math.log1p(access) / math.log1p(50.0), 1.0)
    retention = fusion.decay_factor(meta, memory, now)
    return max(0.0, min(1.0, 0.5 * age_part + 0.3 * access_part
                        + 0.2 * retention))


_CAVEATS = {
    "english": {
        "crystallized": "This belief is well-established and strongly "
                        "supported by its neighborhood.",
        "contested": "This belief is actively contradicted by other "
                     "memories; treat it with caution.",
        "volatile": "This belief is weakly supported and may change; "
                    "verify before relying on it.",
        "forming": "This belief is still forming; supporting evidence is "
                   "accumulating.",
    },
    "italian": {
        "crystallized": "Questa convinzione è consolidata e fortemente "
                        "supportata dal suo contesto.",
        "contested": "Questa convinzione è contraddetta da altre memorie; "
                     "trattala con cautela.",
        "volatile": "Questa convinzione è debolmente supportata e potrebbe "
                    "cambiare; verificala prima di usarla.",
        "forming": "Questa convinzione è ancora in formazione; le prove si "
                   "stanno accumulando.",
    },
}


def _caveat(state: str, language: str) -> str:
    return _CAVEATS.get(language, _CAVEATS["english"])[state]
