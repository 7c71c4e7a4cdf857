"""The index state as tensors: the state half of
kektordb_tpu/index/hnsw_kernels.py.

The whole index is one tuple of fixed-shape device tensors, with the
reference's layout field for field, so that a state carries across
between the two packages unchanged:

  vectors  [cap, D]          the arena, storage dtype
  norms    [cap] f32         |x|^2 (L2 f32/bf16) or int-domain norms (int8)
  nbrs     [cap, M0] int32   level-0 adjacency, -1 padded
  levels   [cap] int32       level per node, -1 for unallocated rows
  deleted  [cap] bool        soft delete
  up_*                       compact upper-level adjacency
  entry, max_level, size     0-dim int32

The graph fields (nbrs, up_*, entry, max_level) are kept and carried but
only the graph build, not ported yet, writes them.

The reference's functions are pure and donate their input; here they
update the state's tensors IN PLACE and return the state. The reference
pads a chunk's rows with -1 and relies on a positive out-of-range sentinel
(`_oob`) to drop them in its scatters; a negative index in torch wraps to
the last row instead, so every scatter here masks the -1 rows out first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")


class GraphState(NamedTuple):
    vectors: torch.Tensor
    norms: torch.Tensor
    nbrs: torch.Tensor
    levels: torch.Tensor
    deleted: torch.Tensor
    up_of: torch.Tensor
    up_node: torch.Tensor
    up_nbrs: torch.Tensor
    up_dists: torch.Tensor
    entry: torch.Tensor
    max_level: torch.Tensor
    size: torch.Tensor


def init_state(cap: int, dim: int, dtype: torch.dtype, *, m0: int,
               lmax: int, mu: int, ucap: int, device) -> GraphState:
    def full(shape, val, dt):
        return torch.full(shape, val, dtype=dt, device=device)
    i32 = torch.int32
    return GraphState(
        vectors=torch.zeros((cap, dim), dtype=dtype, device=device),
        norms=full((cap,), 0.0, torch.float32),
        nbrs=full((cap, m0), -1, i32),
        levels=full((cap,), -1, i32),
        deleted=full((cap,), False, torch.bool),
        up_of=full((cap,), -1, i32),
        up_node=full((ucap,), -1, i32),
        up_nbrs=full((ucap, lmax, mu), -1, i32),
        up_dists=full((ucap, lmax, mu), INF, torch.float32),
        entry=full((), -1, i32),
        max_level=full((), 0, i32),
        size=full((), 0, i32),
    )


def _grow(t: torch.Tensor, extra: int, val) -> torch.Tensor:
    pad = torch.full((extra, *t.shape[1:]), val, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad])


def grow_state(state: GraphState, new_cap: int,
               new_ucap: int) -> GraphState:
    """Capacity-tier growth: new tensors, padded like the reference."""
    pc = new_cap - state.vectors.shape[0]
    pu = new_ucap - state.up_node.shape[0]
    return state._replace(
        vectors=_grow(state.vectors, pc, 0),
        norms=_grow(state.norms, pc, 0.0),
        nbrs=_grow(state.nbrs, pc, -1),
        levels=_grow(state.levels, pc, -1),
        deleted=_grow(state.deleted, pc, False),
        up_of=_grow(state.up_of, pc, -1),
        up_node=_grow(state.up_node, pu, -1),
        up_nbrs=_grow(state.up_nbrs, pu, -1),
        up_dists=_grow(state.up_dists, pu, INF),
    )


def _real(rows: torch.Tensor):
    """(mask of the non-padding entries, their rows as int64 indices)."""
    keep = rows >= 0
    return keep, rows[keep].long()


def write_vectors(state: GraphState, rows: torch.Tensor, vecs: torch.Tensor,
                  norms: torch.Tensor) -> GraphState:
    """Write encoded vectors into the arena (in place)."""
    keep, r = _real(rows)
    state.vectors[r] = vecs[keep]
    state.norms[r] = norms[keep]
    state.deleted[r] = False
    return state


def stage_vectors(state: GraphState, rows: torch.Tensor, vecs: torch.Tensor,
                  norms: torch.Tensor, levels: torch.Tensor) -> GraphState:
    """Make rows scan-visible (arena write + level stamp), in place. The
    scan sees a row as live once its level is >= 0; no graph linking."""
    if rows.numel() == 0:
        return state
    keep, r = _real(rows)
    write_vectors(state, rows, vecs, norms)
    state.levels[r] = levels[keep].to(torch.int32)
    top = torch.where(keep, rows + 1, 0).max().to(torch.int32)
    state.size.copy_(torch.maximum(state.size, top))
    return state


def mark_deleted(state: GraphState, rows: torch.Tensor) -> GraphState:
    """Soft delete (in place)."""
    _, r = _real(rows)
    state.deleted[r] = True
    return state


def purge_rows(state: GraphState, rows: torch.Tensor,
               up_slots: torch.Tensor) -> GraphState:
    """Clear deleted rows after vacuum (in place): zero their arena bytes,
    free their slots and strip them from every neighbor row."""
    _, r = _real(rows)
    _, u = _real(up_slots)
    dead = torch.zeros_like(state.deleted)
    dead[r] = True
    state.nbrs.masked_fill_(
        dead[state.nbrs.clamp_min(0).long()] & (state.nbrs >= 0), -1)
    state.nbrs[r] = -1
    dead_ref = dead[state.up_nbrs.clamp_min(0).long()] & (state.up_nbrs >= 0)
    state.up_nbrs.masked_fill_(dead_ref, -1)
    state.up_dists.masked_fill_(dead_ref, INF)
    state.vectors[r] = 0
    state.norms[r] = 0.0
    state.levels[r] = -1
    state.deleted[r] = False
    state.up_of[r] = -1
    state.up_node[u] = -1
    state.up_nbrs[u] = -1
    state.up_dists[u] = INF
    return state
