"""Hybrid score fusion + memory time-decay.

Reference: searchWithFusion (pkg/engine/ops.go:896-1208) — min-max normalize
vector and BM25 scores (search_utils.go:48-72), weighted-sum fusion
alpha*vec + (1-alpha)*text (ops.go:1086-1097), then per-node time decay
(exponential / linear / step / Ebbinghaus, search_utils.go:91-141) with
`_pinned` exemption and per-layer half-lives (ops.go:1100-1186).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Optional

PINNED_KEY = "_pinned"
CREATED_KEY = "_created_at"
ACCESSED_KEY = "_last_accessed"
ACCESS_COUNT_KEY = "_access_count"
LAYER_KEY = "_memory_layer"


@dataclass
class LayerConfig:
    """Per-memory-layer overrides (hnsw/config.go:177-230)."""
    decay_half_life: float = 0.0        # seconds; 0 → inherit
    pinned_by_default: bool = False
    decay_model: str = ""


@dataclass
class MemoryConfig:
    """Decay configuration (hnsw/config.go:147-230)."""
    enabled: bool = False
    decay_half_life: float = 30 * 24 * 3600.0   # 30 days
    decay_model: str = "exponential"            # |linear|step|ebbinghaus
    layers: dict[str, LayerConfig] = field(default_factory=dict)


def minmax_normalize(scores: dict[int, float], invert: bool = False
                     ) -> dict[int, float]:
    """Map to [0, 1]; invert=True for distances (lower is better)
    (search_utils.go:48-72)."""
    if not scores:
        return {}
    lo, hi = min(scores.values()), max(scores.values())
    span = hi - lo
    if span <= 0:
        return {k: 1.0 for k in scores}
    if invert:
        return {k: (hi - v) / span for k, v in scores.items()}
    return {k: (v - lo) / span for k, v in scores.items()}


def fuse(vec_scores: dict[int, float], text_scores: dict[int, float],
         alpha: float) -> dict[int, float]:
    """alpha*vec + (1-alpha)*text over the union (ops.go:1086-1097).
    vec_scores must already be similarities in [0,1]."""
    out: dict[int, float] = {}
    for k in set(vec_scores) | set(text_scores):
        out[k] = alpha * vec_scores.get(k, 0.0) \
            + (1.0 - alpha) * text_scores.get(k, 0.0)
    return out


def decay_factor(meta: Optional[dict[str, Any]], cfg: MemoryConfig,
                 now: Optional[float] = None) -> float:
    """Retention multiplier in (0, 1] for one node (search_utils.go:91-141).

    Models:
      exponential  0.5 ** (age / half_life)
      linear       max(0, 1 - age / (2 * half_life))
      step         1.0 while age < half_life, 0.5 afterwards
      ebbinghaus   exp(-age / S), S = half_life * (1 + ln(1 + access_count))
    `_pinned` nodes never decay; `_last_accessed` refreshes the clock.
    """
    if not cfg.enabled or meta is None:
        return 1.0
    if _truthy(meta.get(PINNED_KEY)):
        return 1.0
    ref = meta.get(ACCESSED_KEY) or meta.get(CREATED_KEY)
    ts = _parse_ts(ref)
    if ts is None:
        return 1.0
    now = now if now is not None else time.time()
    age = max(now - ts, 0.0)

    half_life = cfg.decay_half_life
    model = cfg.decay_model
    layer = meta.get(LAYER_KEY)
    if layer and layer in cfg.layers:
        lc = cfg.layers[layer]
        if lc.decay_half_life > 0:
            half_life = lc.decay_half_life
        if lc.decay_model:
            model = lc.decay_model
    if half_life <= 0:
        return 1.0

    if model == "linear":
        return max(0.0, 1.0 - age / (2.0 * half_life))
    if model == "step":
        return 1.0 if age < half_life else 0.5
    if model == "ebbinghaus":
        count = float(meta.get(ACCESS_COUNT_KEY) or 0.0)
        s = half_life * (1.0 + math.log1p(count))
        return math.exp(-age / s)
    return 0.5 ** (age / half_life)


def decay_factors(cols, rows: "np.ndarray", cfg: MemoryConfig,
                  now: Optional[float] = None) -> "np.ndarray":
    """Vectorized decay_factor over a row array using the columnar mirror
    (metadata.DecayColumns). rows may contain -1 / out-of-range entries
    (padding) — those get factor 1.0. Matches decay_factor element-wise."""
    import numpy as np
    rows = np.asarray(rows, np.int64)
    out = np.ones(rows.shape, np.float64)
    if not cfg.enabled or rows.size == 0:
        return out
    valid = (rows >= 0) & (rows < cols.cap)
    r = np.where(valid, rows, 0)
    ref = cols.accessed[r]
    ref = np.where(np.isnan(ref), cols.created[r], ref)
    active = valid & ~cols.pinned[r] & ~np.isnan(ref)
    if not active.any():
        return out
    now = now if now is not None else time.time()
    age = np.maximum(now - ref, 0.0)

    # per-layer half-life / model override tables (few layers; built per call)
    n_layers = len(cols.layer_names)
    hl_by_layer = np.full(n_layers + 1, cfg.decay_half_life)
    model_by_layer = np.full(n_layers + 1, _MODEL_IDS.get(
        cfg.decay_model, 0), np.int8)
    for i, name in enumerate(cols.layer_names):
        lc = cfg.layers.get(name)
        if lc is None:
            continue
        if lc.decay_half_life > 0:
            hl_by_layer[i] = lc.decay_half_life
        if lc.decay_model:
            model_by_layer[i] = _MODEL_IDS.get(lc.decay_model, 0)
    lid = cols.layer[r].astype(np.int64)
    lid = np.where(lid >= 0, lid, n_layers)          # last slot = defaults
    half_life = hl_by_layer[lid]
    model = model_by_layer[lid]
    active &= half_life > 0
    hl = np.where(half_life > 0, half_life, 1.0)

    with np.errstate(over="ignore", invalid="ignore"):
        exp_f = 0.5 ** (age / hl)
        lin_f = np.maximum(0.0, 1.0 - age / (2.0 * hl))
        step_f = np.where(age < hl, 1.0, 0.5)
        s = hl * (1.0 + np.log1p(
            np.maximum(cols.count[r].astype(np.float64), 0.0)))
        ebb_f = np.exp(-age / s)
    f = np.select([model == 1, model == 2, model == 3],
                  [lin_f, step_f, ebb_f], default=exp_f)
    return np.where(active, f, out)


_MODEL_IDS = {"exponential": 0, "linear": 1, "step": 2, "ebbinghaus": 3}


def _truthy(v: Any) -> bool:
    if isinstance(v, str):
        return v.lower() in ("true", "1", "yes")
    return bool(v)


def _parse_ts(v: Any) -> Optional[float]:
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            pass
        try:
            import datetime as dt
            return dt.datetime.fromisoformat(v.replace("Z", "+00:00")).timestamp()
        except ValueError:
            return None
    return None
