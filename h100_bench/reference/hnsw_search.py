"""A textbook HNSW search over a graph the program built, in plain
PyTorch and Python: Malkov & Yashunin, "Efficient and robust approximate
nearest neighbor search using Hierarchical Navigable Small World graphs"
(arXiv:1603.09320), Algorithm 5 K-NN-SEARCH with Algorithm 2
SEARCH-LAYER.

From the entry point, a greedy search with ef = 1 through each upper
layer, top to 1, hands its nearest element to the next layer; at layer 0
SEARCH-LAYER runs with ef = max(ef_search, k) and the k nearest of its
result set are the answer. SEARCH-LAYER expands one element at a time:
the nearest of a candidate min-heap, until that is farther than the
farthest of a result max-heap of at most ef elements; every neighbour
not yet visited is scored, and joins both heaps where it is nearer than
the farthest result or the results number fewer than ef. Distances are
float64, squared euclidean or 1 - cos, computed from the rows.

The graph is read as the program lays it out (`GraphState`): `entry`,
`max_level`, `levels` [cap], level-0 neighbours `nbrs` [cap, 2M] (-1
padded), and the upper layers' rows `up_nbrs[up_of[node], level - 1]`.
Departures from the paper:
- the graph is given, not built here, so Algorithm 1's INSERT and the
  neighbour-selection heuristic (Algorithm 4) are not part of it; the
  program's upper layers hold each node's exact nearest M among the
  nodes of that level, which this search reads as any neighbour list;
- ties in distance go to the lower row, so the result is deterministic;
- rows marked deleted are neither traversed nor returned differently
  from live ones: the configurations this serves delete no row.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch


class Graph:
    """A program's graph as host lists, and its rows as float64."""

    def __init__(self, state, metric: str):
        self.metric = metric
        self.entry = int(state.entry)
        self.max_level = int(state.max_level)
        vec = state.vectors.detach().to("cpu", torch.float64)
        if metric == "cosine":
            vec = vec / torch.linalg.vector_norm(vec, dim=1, keepdim=True
                                                 ).clamp_min(1e-300)
        self.vectors = vec
        self.layer0 = state.nbrs.detach().cpu().tolist()
        self.up_of = state.up_of.detach().cpu().tolist()
        self.up_nbrs = state.up_nbrs.detach().cpu().numpy()

    def neighbours(self, node: int, level: int) -> list[int]:
        if level == 0:
            row = self.layer0[node]
        else:
            u = self.up_of[node]
            if u < 0:
                return []
            row = self.up_nbrs[u, level - 1].tolist()
        return [e for e in row if e >= 0]

    def dist(self, q: torch.Tensor, rows: list[int]) -> list[float]:
        x = self.vectors[rows]
        if self.metric == "cosine":
            return (1.0 - x @ q).tolist()
        return ((x - q) ** 2).sum(1).tolist()


def search_layer(g: Graph, q: torch.Tensor, eps: list[tuple[float, int]],
                 ef: int, level: int) -> list[tuple[float, int]]:
    """Algorithm 2: the ef nearest elements found from the entry points
    `eps` [(distance, row)], ascending."""
    visited = {r for _, r in eps}
    cand = list(eps)                              # min-heap by distance
    heapq.heapify(cand)
    res = [(-d, -r) for d, r in eps]              # max-heap, farthest first
    heapq.heapify(res)
    while len(res) > ef:
        heapq.heappop(res)
    while cand:
        dc, c = heapq.heappop(cand)
        if (dc, c) > (-res[0][0], -res[0][1]):
            break
        fresh = [e for e in g.neighbours(c, level) if e not in visited]
        visited.update(fresh)
        if not fresh:
            continue
        for de, e in zip(g.dist(q, fresh), fresh):
            if len(res) < ef or (de, e) < (-res[0][0], -res[0][1]):
                heapq.heappush(cand, (de, e))
                heapq.heappush(res, (-de, -e))
                if len(res) > ef:
                    heapq.heappop(res)
    return sorted((-d, -r) for d, r in res)


def knn_search(g: Graph, q: torch.Tensor, k: int, ef: int
               ) -> list[tuple[float, int]]:
    """Algorithm 5: the k nearest [(distance, row)], ascending."""
    ep = [(g.dist(q, [g.entry])[0], g.entry)]
    for level in range(g.max_level, 0, -1):
        ep = search_layer(g, q, ep, 1, level)[:1]
    return search_layer(g, q, ep, max(ef, k), 0)[:k]


def search(state, queries, k: int, ef: int, metric: str
           ) -> tuple[np.ndarray, np.ndarray]:
    """(rows int64 [Q, k], distances float64 [Q, k]) of each query; -1
    and inf where the graph holds fewer than k rows."""
    g = Graph(state, metric)
    q64 = torch.as_tensor(np.asarray(queries), dtype=torch.float64)
    if metric == "cosine":
        q64 = q64 / torch.linalg.vector_norm(q64, dim=1, keepdim=True
                                             ).clamp_min(1e-300)
    rows = np.full((q64.shape[0], k), -1, np.int64)
    dist = np.full((q64.shape[0], k), np.inf)
    if g.entry < 0:
        return rows, dist
    for i in range(q64.shape[0]):
        hits = knn_search(g, q64[i], k, ef)
        for j, (d, r) in enumerate(hits):
            rows[i, j], dist[i, j] = r, d
    return rows, dist
