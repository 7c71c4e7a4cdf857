"""One question a request, plain JSON: `query_vector` as JSON numbers,
with its own `text_query` and `alpha` where the mix reads hybrid; the
answer is the hit list `results` ({"id", "score"[, "distance"]})."""

from __future__ import annotations

import json

import numpy as np

ROUTE = "/vector/actions/search"


def body(index: str, queries: np.ndarray, texts, idx: np.ndarray,
         mix: dict) -> bytes:
    (i,) = idx.tolist()
    b = {"index_name": index, "query_vector": queries[i].tolist(),
         "k": int(mix["k"])}
    if mix["read"] == "hybrid":
        b["text_query"] = texts[i]
        b["alpha"] = float(mix["alpha"])
    return json.dumps(b).encode()


def decode(raw: bytes, n: int, k: int):
    """As batch_b64.decode, for the one answer."""
    hits = json.loads(raw)["results"]
    rows = np.full((1, k), -1, np.int64)
    dist = np.full((1, k), np.nan)
    score = np.full((1, k), np.nan)
    for j, h in enumerate(hits[:k]):
        rows[0, j] = int(h["id"])
        score[0, j] = h["score"]
        if h.get("distance") is not None:
            dist[0, j] = h["distance"]
    return rows, dist, score
