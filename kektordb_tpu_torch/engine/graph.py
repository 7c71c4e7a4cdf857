"""Temporal knowledge graph — host-side property graph with time travel.

Reference: pkg/core/graph.go — 128-shard in-RAM graph with
GraphNode{OutEdges map[rel][]GraphEdge, InEdges map[rel][]ReverseEdge}
(graph.go:20-54), soft-delete + `isActiveAtTime` filtering on every read
(graph.go:350-364), VacuumGraph purge (graph.go:367). Graph IDs are
namespaced "index/node" (pkg/engine/graph.go:24-38).

TPU-first note (SURVEY §7.3 M5): this is request-path, pointer-chasing,
low-QPS state — its idiomatic home is host code. The device only sees it as
bitmask row sets when a graph BFS restricts a vector search
(resolveGraphFilter, ops.go:941-962). Go's 128 shard mutexes disappear:
the engine serializes writes (single-writer), reads are lock-free dict reads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional


@dataclass
class Edge:
    """Full out-edge (graph.go:20-38): target, lifetime, weight, props."""
    target: str
    created_at: float
    deleted_at: float = 0.0          # 0 → alive
    weight: float = 1.0
    props: dict[str, Any] = field(default_factory=dict)

    def active_at(self, t: Optional[float]) -> bool:
        """Time-travel visibility (isActiveAtTime, graph.go:350-364)."""
        if t is None:
            return self.deleted_at == 0.0
        return self.created_at <= t and (self.deleted_at == 0.0
                                         or t < self.deleted_at)


@dataclass
class ReverseEdge:
    """Compact in-edge (graph.go:40-54)."""
    source: str
    created_at: float
    deleted_at: float = 0.0

    def active_at(self, t: Optional[float]) -> bool:
        if t is None:
            return self.deleted_at == 0.0
        return self.created_at <= t and (self.deleted_at == 0.0
                                         or t < self.deleted_at)


class KnowledgeGraph:
    def __init__(self) -> None:
        # node id → relation → [Edge]
        self.out: dict[str, dict[str, list[Edge]]] = {}
        self.inc: dict[str, dict[str, list[ReverseEdge]]] = {}
        # bumped on every mutation — cache-invalidation key for derived
        # row sets (engine graph-restriction mask cache)
        self.version = 0

    # -- mutation -----------------------------------------------------------

    def add_edge(self, source: str, relation: str, target: str, *,
                 weight: float = 1.0, props: Optional[dict] = None,
                 created_at: Optional[float] = None) -> None:
        """AddEdge (core/graph.go:112): duplicate live edges are refreshed,
        not duplicated."""
        self.version += 1
        now = created_at if created_at is not None else time.time()
        edges = self.out.setdefault(source, {}).setdefault(relation, [])
        for e in edges:
            if e.target == target and e.deleted_at == 0.0:
                e.weight = weight
                if props is not None:
                    e.props = dict(props)
                return
        edges.append(Edge(target, now, 0.0, weight, dict(props or {})))
        self.inc.setdefault(target, {}).setdefault(relation, []).append(
            ReverseEdge(source, now))

    def remove_edge(self, source: str, relation: str, target: str, *,
                    deleted_at: Optional[float] = None) -> bool:
        """Soft delete → time travel keeps history (core/graph.go:187)."""
        self.version += 1
        now = deleted_at if deleted_at is not None else time.time()
        hit = False
        for e in self.out.get(source, {}).get(relation, []):
            if e.target == target and e.deleted_at == 0.0:
                e.deleted_at = now
                hit = True
        for r in self.inc.get(target, {}).get(relation, []):
            if r.source == source and r.deleted_at == 0.0:
                r.deleted_at = now
        return hit

    def drop_node(self, node: str, *, deleted_at: Optional[float] = None) -> None:
        """Soft-delete every edge touching the node."""
        self.version += 1
        now = deleted_at if deleted_at is not None else time.time()
        for rel, edges in self.out.get(node, {}).items():
            for e in edges:
                if e.deleted_at == 0.0:
                    e.deleted_at = now
                    for r in self.inc.get(e.target, {}).get(rel, []):
                        if r.source == node and r.deleted_at == 0.0:
                            r.deleted_at = now
        for rel, redges in self.inc.get(node, {}).items():
            for r in redges:
                if r.deleted_at == 0.0:
                    r.deleted_at = now
                    for e in self.out.get(r.source, {}).get(rel, []):
                        if e.target == node and e.deleted_at == 0.0:
                            e.deleted_at = now

    def vacuum(self, cutoff: float) -> int:
        """Physically purge soft-deleted edges older than cutoff + empty
        ghost nodes (VacuumGraph, core/graph.go:367)."""
        self.version += 1
        purged = 0
        for node in list(self.out):
            rels = self.out[node]
            for rel in list(rels):
                kept = [e for e in rels[rel]
                        if e.deleted_at == 0.0 or e.deleted_at >= cutoff]
                purged += len(rels[rel]) - len(kept)
                if kept:
                    rels[rel] = kept
                else:
                    del rels[rel]
            if not rels:
                del self.out[node]
        for node in list(self.inc):
            rels = self.inc[node]
            for rel in list(rels):
                kept = [r for r in rels[rel]
                        if r.deleted_at == 0.0 or r.deleted_at >= cutoff]
                if kept:
                    rels[rel] = kept
                else:
                    del rels[rel]
            if not rels:
                del self.inc[node]
        return purged

    # -- reads (all time-travel aware) ----------------------------------------

    def out_edges(self, node: str, relation: Optional[str] = None,
                  at_time: Optional[float] = None) -> list[tuple[str, Edge]]:
        """GetOutEdges (core/graph.go:247)."""
        out = []
        for rel, edges in self.out.get(node, {}).items():
            if relation and rel != relation:
                continue
            out.extend((rel, e) for e in edges if e.active_at(at_time))
        return out

    def in_edges(self, node: str, relation: Optional[str] = None,
                 at_time: Optional[float] = None) -> list[tuple[str, ReverseEdge]]:
        """GetInEdges (core/graph.go:275)."""
        out = []
        for rel, redges in self.inc.get(node, {}).items():
            if relation and rel != relation:
                continue
            out.extend((rel, r) for r in redges if r.active_at(at_time))
        return out

    def relations(self) -> list[str]:
        """GetAllRelations (core/graph.go:303)."""
        rels = set()
        for d in self.out.values():
            rels.update(d.keys())
        return sorted(rels)

    def neighbors(self, node: str, at_time: Optional[float] = None,
                  relation: Optional[str] = None) -> Iterator[str]:
        for _, e in self.out_edges(node, relation, at_time):
            yield e.target

    # -- traversals ------------------------------------------------------------

    def bfs(self, roots: list[str], depth: int, *,
            relation: Optional[str] = None,
            at_time: Optional[float] = None,
            both_directions: bool = True,
            limit: int = 100_000) -> set[str]:
        """Bounded BFS for graph-restricted search (resolveGraphFilter,
        engine/graph.go:173-246; depth clamp 5 applied by the caller)."""
        seen = set(roots)
        frontier = list(roots)
        for _ in range(depth):
            nxt = []
            for node in frontier:
                for _, e in self.out_edges(node, relation, at_time):
                    if e.target not in seen:
                        seen.add(e.target)
                        nxt.append(e.target)
                        if len(seen) >= limit:
                            return seen
                if both_directions:
                    for _, r in self.in_edges(node, relation, at_time):
                        if r.source not in seen:
                            seen.add(r.source)
                            nxt.append(r.source)
                            if len(seen) >= limit:
                                return seen
            frontier = nxt
            if not frontier:
                break
        return seen

    def find_path(self, start: str, goal: str, *, max_depth: int = 10,
                  relation: Optional[str] = None,
                  at_time: Optional[float] = None) -> Optional[list[str]]:
        """Bidirectional BFS with per-side parent maps
        (pkg/engine/pathfinding.go:16)."""
        if start == goal:
            return [start]
        fwd_parent: dict[str, Optional[str]] = {start: None}
        bwd_parent: dict[str, Optional[str]] = {goal: None}
        fwd, bwd = [start], [goal]

        def expand(frontier, parents, forward):
            nxt = []
            for node in frontier:
                links = (self.out_edges(node, relation, at_time) if forward
                         else self.in_edges(node, relation, at_time))
                for _, e in links:
                    other = e.target if forward else e.source
                    if other not in parents:
                        parents[other] = node
                        nxt.append(other)
            return nxt

        for _ in range(max_depth):
            if not fwd and not bwd:
                return None
            if fwd and (len(fwd) <= len(bwd) or not bwd):
                fwd = expand(fwd, fwd_parent, True)
            else:
                bwd = expand(bwd, bwd_parent, False)
            meet = (set(fwd_parent) & set(bwd_parent))
            if meet:
                m = next(iter(meet))
                left = []
                cur: Optional[str] = m
                while cur is not None:
                    left.append(cur)
                    cur = fwd_parent[cur]
                left.reverse()
                cur = bwd_parent[m]
                while cur is not None:
                    left.append(cur)
                    cur = bwd_parent[cur]
                return left
        return None
