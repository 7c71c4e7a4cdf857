"""HNSW as dense device tensors: the PyTorch port of
kektordb_tpu/index/hnsw_kernels.py.

The whole index is one tuple of fixed-shape device tensors, with the
reference's layout field for field, so that a state carries across
between the two packages unchanged:

  vectors  [cap, D]          the arena, storage dtype
  norms    [cap] f32         |x|^2 (L2 f32/bf16) or int-domain norms (int8)
  nbrs     [cap, M0] int32   level-0 adjacency, -1 padded
  levels   [cap] int32       level per node, -1 for unallocated rows
  deleted  [cap] bool        soft delete
  up_*                       compact upper-level adjacency (exact KNN rows)
  entry, max_level, size     0-dim int32

Searches run as batched lockstep beam traversal (`beam_search`): B queries
advance together, each iteration gathers the neighbour rows of the best
unexpanded candidates, scores them with `distance.gathered` (the CUDA
gather-distance kernel on the card) and merges them into the pools with
one stable sort. Construction is chunked batch insert: beam candidates +
intra-chunk candidates -> `select_neighbors` -> `commit_chunk` (forward
links, sort-grouped reverse links, distance-pruned merge); the upper layers
are exact-KNN rows (`update_upper`); `refine_chunk` re-selects rows.

The reference's functions are pure, jitted and donate their input; here
they update the state's tensors IN PLACE and return the state. JAX idioms
and their counterparts:
  * `mode="drop"` scatters with a positive out-of-range sentinel (`_oob`):
    a negative index in torch wraps to the last row, so every scatter here
    masks the -1 rows out first (`_real`).
  * `lax.while_loop`: a bounded loop that asks the device whether every
    query is done only every CHECK_EVERY iterations. A finished query's
    iteration only merges +inf / -1 entries, which leaves its pools as
    they are, so the extra iterations change no result. The iterations
    between two asks run as one block of `_Loop`, which the card replays
    from a CUDA graph where `beam_search` says.
  * `lax.sort` / `lax.top_k` / `jnp.argsort` / `jnp.lexsort`: stable
    `torch.sort` (ties keep the lower index first, as `top_k` does).
  * `associative_scan(maximum)`: `torch.cummax`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..ops import distance as dist

INF = float("inf")
I32_MAX = 2 ** 31 - 1

# beam and descent loops ask the device whether they are done only this
# often (each ask is a host-device synchronisation)
CHECK_EVERY = 4
MAX_HOPS = 64          # descent hops per level
# captured beam blocks kept, least recently used out, and shape keys
# remembered as seen once
GRAPH_ENTRIES = 8
GRAPH_SEEN = 64


class BeamStats:
    """What one `beam_search` call did, for the caller's counters: the
    loop's iterations, its host-device synchronisations (each test of
    whether every query is done), and after the call `scored`, a 0-dim
    device tensor of the neighbour ids it scored, summed on the device
    so that reading it costs no synchronisation inside the loop."""

    __slots__ = ("iterations", "done_checks", "scored")

    def __init__(self):
        self.iterations = 0
        self.done_checks = 0
        self.scored: Optional[torch.Tensor] = None


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


def rows_referencing_deleted(state: GraphState) -> torch.Tensor:
    """[cap] bool: live rows whose level-0 row points at a deleted node
    (vacuum's parent scan)."""
    nb = state.nbrs
    nb_del = state.deleted[nb.clamp_min(0).long()] & (nb >= 0)
    return nb_del.any(1) & (state.levels >= 0) & ~state.deleted


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k smallest of each row, ascending; ties
    keep the lower position first, as `lax.top_k(-d, k)` does."""
    v, pos = torch.sort(d, dim=1, stable=True)
    return v[:, :k], pos[:, :k]


def _seen(x: torch.Tensor, *pools: torch.Tensor,
          earlier: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, C] bool: where x [B, C] is in one of the pools [B, *] or, with
    `earlier` (the [C, C] mask of the pairs j < i), equals an earlier
    entry of its own row. One compare a pool, or-ed in order."""
    xx = x[:, :, None]
    tests = [(p, None) for p in pools]
    if earlier is not None:
        tests.append((x, earlier))
    dup = None
    for p, mask in tests:
        hit = xx == p[:, None, :]
        hit = (hit if mask is None else hit & mask).any(2)
        dup = hit if dup is None else dup.bitwise_or_(hit)
    return dup


def _gathered(state: GraphState, ids, q, qn, metric):
    return dist.gathered(state.vectors, ids, q, metric,
                         corpus_norms=state.norms, query_norms=qn)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# greedy descent over the upper exact-KNN layers
# ---------------------------------------------------------------------------

def descend(state: GraphState, q: torch.Tensor, qn: Optional[torch.Tensor],
            metric: str) -> torch.Tensor:
    """[B, D] queries -> [B] level-0 start rows: from the entry point, hop
    to the nearest upper neighbour while that is closer, level by level.
    A hop in which no query moves changes nothing, so the loop may run a
    few past the reference's stop (it asks every CHECK_EVERY hops)."""
    B = q.shape[0]
    cur = state.entry.expand(B).clone()
    curd = _gathered(state, cur[:, None], q, qn, metric)[:, 0]
    for lvl in range(int(state.max_level), 0, -1):
        for hop in range(MAX_HOPS):
            uidx = state.up_of[cur.clamp_min(0).long()]
            nb = state.up_nbrs[uidx.clamp_min(0).long(), lvl - 1]   # [B, MU]
            nb = torch.where(uidx[:, None] >= 0, nb, -1)
            d = _gathered(state, nb, q, qn, metric)
            j = torch.argmin(d, dim=1, keepdim=True)
            bd = d.gather(1, j)[:, 0]
            moved = bd < curd
            cur = torch.where(moved, nb.gather(1, j)[:, 0], cur)
            curd = torch.minimum(bd, curd)
            if (hop + 1) % CHECK_EVERY == 0 and not bool(moved.any()):
                break
    return cur


# ---------------------------------------------------------------------------
# batched lockstep beam search at level 0
# ---------------------------------------------------------------------------

def _merge(pd, pi, px, nd, ni, width: int):
    """Concatenate two pools and keep the `width` nearest (stable)."""
    ad = torch.cat([pd, nd], 1)
    ai = torch.cat([pi, ni], 1)
    ax = torch.cat([px, torch.zeros_like(ni, dtype=torch.bool)], 1)
    sd, order = _smallest(ad, width)
    return sd, ai.gather(1, order), ax.gather(1, order)


def _filter_seeds(state: GraphState, q, qn, metric, allow, seeds):
    """Seeds for a filtered search: beside the descent's start, each query's
    S_SEED nearest of S_SAMPLE allowed rows spread evenly over the arena
    (ranks through the allow mask's cumsum); duplicate seeds become -1."""
    cap = allow.shape[0]
    B = q.shape[0]
    s_sample, s_seed = min(128, cap), 4
    c = torch.cumsum(allow.to(torch.int32), 0)
    total = c[-1].float()
    ranks = torch.minimum(
        (torch.arange(s_sample, dtype=torch.float32, device=q.device) + 0.5)
        * total / s_sample, torch.clamp_min(total - 1, 0)) + 1
    probe = torch.searchsorted(c, ranks.to(c.dtype), side="left")
    probe = torch.clamp_max(probe, cap - 1)
    pd = dist.pairwise(q, state.vectors[probe], metric,
                       corpus_norms=state.norms[probe], query_norms=qn)
    _, best = _smallest(pd, s_seed)
    extra = torch.where(c[-1] > 0, probe[best].to(torch.int32),
                        seeds.expand(B, s_seed))
    seeds = torch.cat([seeds, extra], 1)                  # [B, 1 + S_SEED]
    S = seeds.shape[1]
    earlier = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                    device=q.device), -1)
    return torch.where(_seen(seeds, earlier=earlier), -1, seeds)


def beam_search(state: GraphState, q: torch.Tensor,
                qn: Optional[torch.Tensor], *, metric: str, ef: int,
                expand: int = 4, allow: Optional[torch.Tensor] = None,
                exclude: Optional[torch.Tensor] = None, dual: bool = False,
                seeds: Optional[torch.Tensor] = None,
                stats: Optional[BeamStats] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (res_d [B, ef] ascending, res_i [B, ef]; +inf / -1 padded).

    Each iteration pops the best `expand` unexpanded candidates of every
    query, gathers their neighbour rows, drops ids already in the pool, in
    the expansion-history ring or earlier in the same gather (no visited
    table), scores the rest and merges them with one stable sort.
    dual=False: one pool, valid when every row is result-eligible.
    dual=True: a traversal pool and a result pool; the result pool admits
    only rows that are not deleted, in `allow`, and not `exclude`.
    A query is done when its best unexpanded candidate is no nearer than
    its ef-th result, or after (2 ef) / expand + 24 iterations. The
    expansion history is a ring of min(128, next_pow2(max_iters * expand))
    ids. `seeds` [B] are the level-0 start rows where the caller ran
    `descend` itself; `stats`, where given, is filled in (`BeamStats`).

    The loop asks the device whether every query is done once every
    CHECK_EVERY iterations, and runs the iterations between two asks as
    one block (`_Loop`). On a CUDA device a block of a shape key's second
    and later calls is replayed from a CUDA graph in one launch: it is
    captured the second time the key is seen (the batch, ef, expand, M0,
    the options given, the metric, the dtypes, and the addresses and
    shapes of the arena, norms, adjacency and deleted flags, so that a
    grown state is captured anew), and kept in a small cache shared by
    every thread. The same block runs uncaptured where the key is new,
    where another caller holds the key's entry, for a tail of fewer than
    CHECK_EVERY iterations, and on the CPU; both ways give the same bits.
    The counters `beam.graph_replays`, `beam.graph_captures` and
    `beam.eager_blocks` (uncaptured) count the blocks. The launches sit
    under the profiler range `hnsw.beam`."""
    with tracing.kernel_range("hnsw.beam"):
        return _beam_search(state, q, qn, metric, ef, expand, allow,
                            exclude, dual, seeds, stats)


def _hist_cols(n: int, E: int, R: int, device) -> torch.Tensor:
    """[n, E]: the history ring's columns for the E expanded ids of each
    of iterations 0..n-1. lax.dynamic_update_slice clamps the start so
    that the update fits."""
    start = (torch.arange(n, device=device)[:, None] * E % R).clamp(
        max=R - E)
    return start + torch.arange(E, device=device)


# one CUDA graph capture at a time in the process (torch.cuda.graph)
_CAPTURE_LOCK = threading.Lock()


class _Loop:
    """The level-0 loop of a `beam_search` call on buffers of its own:
    the candidate pool with its expanded flags, the result pool (the
    candidate pool itself unless dual), the expansion history, the done
    flags, the per-query scored counts, and what the iterations read.
    `load` copies a call's inputs (q, qn, res_ok, exclude, cand_d,
    cand_i, cand_x, res_d, res_i; None where a search has no such tensor)
    into them, made at the first load. Each iteration reads its history
    columns from the table `cols` at the device counter `it`, so that one
    block of iterations serves every place in the loop.

    A `_GraphCache` entry is a loop that stays for its shape key's next
    call. On a CUDA device its block of CHECK_EVERY iterations is
    captured as a CUDA graph on first use and replayed after (`run`).
    `busy` marks an entry a caller holds; `ready` is the event after the
    last holder's reads of its buffers."""

    INPUTS = ("q", "qn", "res_ok", "exclude", "cand_d", "cand_i", "cand_x",
              "res_d", "res_i")

    def __init__(self):
        self.busy = False
        self.q = self.state = self.graph = self.ready = None
        self.launches = 0           # gather-distance launches a block
        self.graph_replays = self.graph_captures = self.eager_blocks = 0

    def load(self, state: GraphState, metric: str, E: int, R: int,
             max_iters: int, inputs: tuple, count_scored: bool) -> None:
        dev = inputs[0].device
        if self.ready is not None:
            torch.cuda.current_stream(dev).wait_event(self.ready)
        if self.q is None:
            for name, t in zip(self.INPUTS, inputs):
                setattr(self, name,
                        None if t is None else torch.empty_like(t))
            self.metric, self.E = metric, E
            self.dual = self.res_ok is not None
            if not self.dual:
                self.res_d, self.res_i = self.cand_d, self.cand_i
            # the tensors an iteration replaces rather than writes in
            # place, and the buffers a block leaves them in
            self.buffers = {n: getattr(self, n) for n in
                            self.INPUTS[4:(9 if self.dual else 7)]}
            B, ef = self.cand_d.shape
            C = E * state.nbrs.shape[1]
            self.pad_x = torch.zeros((B, ef), dtype=torch.bool, device=dev) \
                if self.dual else None
            self.hist = torch.empty((B, R), dtype=torch.int32, device=dev)
            self.done = torch.empty(B, dtype=torch.bool, device=dev)
            self.earlier = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                                 device=dev), -1)
            self.scored = torch.empty((B, C), dtype=torch.int32,
                                      device=dev) if count_scored else None
            self.it = torch.empty(1, dtype=torch.long, device=dev)
            self.cols = _hist_cols(max_iters, E, R, dev)
        self.state = state
        for name, t in zip(self.INPUTS, inputs):
            if t is not None:
                getattr(self, name).copy_(t)
        self.hist.fill_(-1)
        self.done.zero_()
        if self.scored is not None:
            self.scored.zero_()
        self.it.zero_()

    def step(self) -> None:
        """One iteration."""
        st, E = self.state, self.E
        B, ef = self.cand_d.shape
        M0 = st.nbrs.shape[1]
        cols = self.cols.index_select(0, self.it)                  # [1, E]
        self.it += 1
        ud = torch.where(self.cand_x | (self.cand_i < 0), INF, self.cand_d)
        sel_d, sel_pos = _smallest(ud, E)                          # [B, E]
        sel_i = self.cand_i.gather(1, sel_pos)
        self.done |= (sel_d[:, 0] >= self.res_d[:, -1]) | (sel_i[:, 0] < 0)
        cand_x = self.cand_x.scatter(1, sel_pos, True)
        self.hist.scatter_(1, cols.expand(B, E), sel_i)

        nb = st.nbrs[sel_i.clamp_min(0).long()].reshape(B, E * M0)
        nb = torch.where((sel_i >= 0).repeat_interleave(M0, dim=1), nb, -1)
        dup = _seen(nb, self.cand_i, self.hist, earlier=self.earlier)
        if self.dual:
            dup |= _seen(nb, self.res_i)
        fresh = (nb >= 0) & ~dup & ~self.done[:, None]
        nb = torch.where(fresh, nb, -1)
        if self.scored is not None:
            self.scored += fresh

        nd = _gathered(st, nb, self.q, self.qn, self.metric)   # inf for -1
        self.cand_d, self.cand_i, self.cand_x = _merge(
            self.cand_d, self.cand_i, cand_x, nd, nb, ef)
        if self.dual:
            ok = fresh & self.res_ok[nb.clamp_min(0).long()]
            if self.exclude is not None:
                ok = ok & (nb != self.exclude[:, None])
            self.res_d, self.res_i, _ = _merge(
                self.res_d, self.res_i, self.pad_x,
                torch.where(ok, nd, INF), torch.where(ok, nb, -1), ef)
        else:
            self.res_d, self.res_i = self.cand_d, self.cand_i

    def block(self, n: int) -> None:
        """n iterations, then the pools copied back into the buffers."""
        for _ in range(n):
            self.step()
        for name, t in self.buffers.items():
            t.copy_(getattr(self, name))
            setattr(self, name, t)
        if not self.dual:
            self.res_d, self.res_i = self.cand_d, self.cand_i

    def run(self, n: int, capture: bool) -> None:
        """n iterations: replayed from the CUDA graph (captured at the
        first) where `capture` (a cache entry's call) holds, n is a whole
        block and the buffers are on a CUDA device, else uncaptured."""
        if not (capture and n == CHECK_EVERY and self.q.is_cuda):
            self.block(n)
            self.eager_blocks += 1
            return
        if self.graph is None:
            # the capture's calls count the block's gather-distance
            # launches, which its first replay makes
            graph = torch.cuda.CUDAGraph()
            dev = self.q.device
            side = torch.cuda.Stream(dev)
            with _CAPTURE_LOCK, torch.cuda.device(dev):
                before = dist.gathered.launches
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    self.block(CHECK_EVERY)
                self.launches = dist.gathered.launches - before
            self.graph = graph
            self.graph_captures += 1
        else:
            dist.gathered.launches += self.launches
        self.graph.replay()
        self.graph_replays += 1

    def release(self) -> None:
        """After the call's last read of the buffers: count its blocks,
        let the state go, and mark where the next holder may write."""
        for name in ("graph_replays", "graph_captures", "eager_blocks"):
            if getattr(self, name):
                tracing.count(f"beam.{name}", getattr(self, name))
                setattr(self, name, 0)
        self.state = None
        if self.q is not None and self.q.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(self.q.device))


def _drive(loop: _Loop, max_iters: int, capture: bool) -> tuple[int, int]:
    """Run the loop's blocks up to max_iters, asking the device between
    blocks whether every query is done, as the reference's while_loop
    stops. Returns (iterations, asks)."""
    it = checks = 0
    while it < max_iters:
        if it:
            checks += 1
            if bool(loop.done.all()):
                break
        n = min(CHECK_EVERY, max_iters - it)
        loop.run(n, capture)
        it += n
    return it, checks


class _GraphCache:
    """Beam loops by shape key, shared by every thread. A key's first
    call gets no entry (it runs a loop of its own, uncaptured), so a
    one-off shape costs no capture; its second call makes the entry. At
    most `size` entries stay, the least recently used going first, and
    `seen` keys are remembered. An entry serves one caller at a time: one
    that finds it busy gets none."""

    def __init__(self, size: int = GRAPH_ENTRIES, seen: int = GRAPH_SEEN,
                 make=_Loop):
        self.size, self.seen_size, self.make = size, seen, make
        self._lock = threading.Lock()
        self._seen: OrderedDict = OrderedDict()
        self._entries: OrderedDict = OrderedDict()

    def acquire(self, key):
        """The key's entry, marked busy, or None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if key not in self._seen:
                    self._seen[key] = None
                    while len(self._seen) > self.seen_size:
                        self._seen.popitem(last=False)
                    return None
                del self._seen[key]
                entry = self._entries[key] = self.make()
                while len(self._entries) > self.size:
                    self._entries.popitem(last=False)
            elif entry.busy:
                return None
            self._entries.move_to_end(key)
            entry.busy = True
            return entry

    def release(self, entry) -> None:
        with self._lock:
            entry.busy = False


_GRAPHS = _GraphCache()


def _graph_key(state: GraphState, q, qn, metric, ef, E, allow, exclude,
               dual, stats) -> tuple:
    """What a captured block depends on: the shapes and dtypes of its
    buffers, the options, and the addresses of the state it reads (a
    replay reads the tensors at those addresses as they are then)."""
    return (q.device, tuple(q.shape), q.dtype,
            None if qn is None else qn.dtype, metric, ef, E, dual,
            allow is not None,
            None if exclude is None else exclude.dtype, stats is not None,
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in (state.vectors, state.norms, state.nbrs,
                            state.deleted)))


def _beam_search(state, q, qn, metric, ef, expand, allow, exclude, dual,
                 seeds, stats):
    """`beam_search`'s body: the key's cache entry on a CUDA device, else
    a loop of its own."""
    B = q.shape[0]
    dev = q.device
    E = max(1, min(expand, ef))
    max_iters = (2 * ef) // E + 24
    R = min(_next_pow2(max_iters * E), 128)

    res_ok = None
    if dual:
        res_ok = ~state.deleted
        if allow is not None:
            res_ok = res_ok & allow

    if seeds is None:
        seeds = descend(state, q, qn, metric)
    seeds = seeds[:, None]                                       # [B, 1]
    if allow is not None:
        seeds = _filter_seeds(state, q, qn, metric, allow, seeds)
    seed_d = _gathered(state, seeds, q, qn, metric)

    pad_d = torch.full((B, ef), INF, device=dev)
    pad_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    pad_x = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    cand_d, cand_i, cand_x = _merge(pad_d, pad_i, pad_x, seed_d, seeds, ef)
    if dual:
        seed_ok = res_ok[seeds.clamp_min(0).long()] & (seeds >= 0)
        if exclude is not None:
            seed_ok = seed_ok & (seeds != exclude[:, None])
        res_d, res_i, _ = _merge(pad_d, pad_i, pad_x,
                                 torch.where(seed_ok, seed_d, INF),
                                 torch.where(seed_ok, seeds, -1), ef)
    else:
        res_d = res_i = None
    inputs = (q, qn, res_ok, exclude if dual else None, cand_d, cand_i,
              cand_x, res_d, res_i)

    loop = _GRAPHS.acquire(_graph_key(state, q, qn, metric, ef, E, allow,
                                      exclude, dual, stats)) \
        if q.is_cuda else None
    cached = loop is not None
    if not cached:
        loop = _Loop()
    try:
        loop.load(state, metric, E, R, max_iters, inputs, stats is not None)
        it, checks = _drive(loop, max_iters, cached)
        # the next holder's replays overwrite the buffers
        res_d = loop.res_d.clone()
        if stats is not None:
            stats.iterations, stats.done_checks = it, checks
            stats.scored = loop.scored.sum()
        out = res_d, torch.where(torch.isinf(res_d), -1, loop.res_i)
    finally:
        loop.release()
        if cached:
            _GRAPHS.release(loop)
    return out


# ---------------------------------------------------------------------------
# select-neighbors diversity heuristic (batched)
# ---------------------------------------------------------------------------

def select_neighbors(state: GraphState, cand_d: torch.Tensor,
                     cand_i: torch.Tensor, m: int, metric: str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep candidate c iff d(c, q) < min over the selected s of d(c, s),
    then backfill the nearest discarded up to m. cand_* [B, C] ascending,
    -1 / +inf padded. Returns (ids [B, m], dists [B, m]). The keep decision
    is sequential in c: a host loop of C small steps."""
    B, C = cand_i.shape
    valid = cand_i >= 0
    safe = cand_i.clamp_min(0).long()
    vecs = state.vectors[safe]                                   # [B, C, D]
    if vecs.dtype == torch.int8:
        v64 = vecs.double()                      # exact integer dots
        dots = torch.bmm(v64, v64.transpose(1, 2)).float()
        if metric == dist.COSINE:
            n = torch.clamp_min(state.norms[safe], 1e-9)
            P = 1.0 - dots / (n[:, :, None] * n[:, None, :])
        else:
            n2 = state.norms[safe] ** 2
            P = n2[:, :, None] - 2.0 * dots + n2[:, None, :]
    else:
        v32 = vecs.float()
        dots = torch.bmm(v32, v32.transpose(1, 2))
        if metric == dist.COSINE:
            P = 1.0 - dots
        else:
            sq = torch.sum(v32 ** 2, dim=-1)
            P = sq[:, :, None] - 2.0 * dots + sq[:, None, :]

    selected = torch.zeros((B, C), dtype=torch.bool, device=cand_i.device)
    count = torch.zeros(B, dtype=torch.int32, device=cand_i.device)
    for c in range(C):
        mind = torch.where(selected, P[:, c, :], INF).amin(1)
        keep = valid[:, c] & (count < m) & (cand_d[:, c] < mind)
        selected[:, c] = keep
        count += keep

    # selected first (ascending), then the discarded backfill, invalid last
    pos = torch.arange(C, device=cand_i.device)[None, :]
    key = torch.where(selected, pos, pos + C)
    key = torch.where(valid, key, pos + 2 * C)
    order = torch.argsort(key, dim=1)[:, :m]
    out_i = cand_i.gather(1, order)
    out_d = cand_d.gather(1, order)
    return torch.where(torch.isinf(out_d), -1, out_i), out_d


# ---------------------------------------------------------------------------
# chunk commit: forward links + sort-grouped reverse links
# ---------------------------------------------------------------------------

def commit_chunk(state: GraphState, rows: torch.Tensor, sel_i: torch.Tensor,
                 sel_d: torch.Tensor, new_levels: torch.Tensor, *,
                 metric: str, m: int, rev_cap: int = 8) -> GraphState:
    """Write each new row's m forward links, group the reverse links
    (dst <- src) by dst with one sort, keep each dst's rev_cap nearest
    entrants, merge them into the dst's row pruned to M0 by distance; then
    stamp levels, entry point, max level and size. In place."""
    C = rows.shape[0]
    M0 = state.nbrs.shape[1]
    dev = rows.device

    fwd = torch.full((C, M0), -1, dtype=torch.int32, device=dev)
    fwd[:, :m] = sel_i
    keep, r = _real(rows)
    state.nbrs[r] = fwd[keep]

    # reverse links (dst, src, d) sorted by (dst, d), nearest first
    src = rows[:, None].expand(C, m).reshape(-1)
    dst = sel_i.reshape(-1)
    pd = sel_d.reshape(-1)
    dst = torch.where((dst >= 0) & (src >= 0), dst, I32_MAX)
    o1 = torch.sort(pd, stable=True)[1]
    order = o1[torch.sort(dst[o1], stable=True)[1]]
    dst_s, src_s, pd_s = dst[order], src[order], pd[order]
    n = dst_s.shape[0]
    ar = torch.arange(n, device=dev)
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = dst_s[1:] != dst_s[:-1]
    seg = torch.cumsum(is_head.long(), 0) - 1
    pos_in_seg = ar - torch.cummax(torch.where(is_head, ar, -1), 0)[0] \
        .clamp_min(0)
    good = dst_s != I32_MAX
    b_src = torch.full((n, rev_cap), -1, dtype=torch.int32, device=dev)
    b_d = torch.full((n, rev_cap), INF, device=dev)
    put = good & (pos_in_seg < rev_cap)
    b_src[seg[put], pos_in_seg[put]] = src_s[put]
    b_d[seg[put], pos_in_seg[put]] = pd_s[put]
    head = is_head & good
    seg_dst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    seg_dst[seg[head]] = dst_s[head]

    # merge the entrants into each dst row, prune to M0 by distance (the
    # diversity heuristic comes back in refine). The reference maps this
    # over blocks of 2048 segments; here it is one batched call.
    dr = seg_dst.clamp_min(0).long()
    old = torch.where(seg_dst[:, None] >= 0, state.nbrs[dr], -1)
    od = dist.gathered(state.vectors, old, state.vectors[dr], metric,
                       corpus_norms=state.norms, query_norms=state.norms[dr])
    dup = _seen(b_src, old)
    all_i = torch.cat([old, torch.where(dup, -1, b_src)], 1)
    all_d = torch.cat([od, torch.where(dup, INF, b_d)], 1)
    top_d, posn = _smallest(all_d, M0)
    new_i = torch.where(torch.isinf(top_d), -1, all_i.gather(1, posn))
    keep_s, r_s = _real(seg_dst)
    state.nbrs[r_s] = new_i[keep_s]

    # levels, entry point, size
    state.levels[r] = new_levels[keep].to(torch.int32)
    lv = torch.where(rows >= 0, new_levels, -1)
    chunk_max = lv.max()
    j = torch.argmax(lv)
    state.entry.copy_(torch.where(
        (chunk_max > state.max_level) | (state.entry < 0), rows[j],
        state.entry))
    state.max_level.copy_(torch.maximum(state.max_level, chunk_max))
    top = torch.where(rows >= 0, rows + 1, 0).max().to(torch.int32)
    state.size.copy_(torch.maximum(state.size, top))
    return state


ADOPT_ROUNDS = 8


def reached(state: GraphState, n: int) -> torch.Tensor:
    """[n] bool: the rows a walk of level-0 links from the entry reaches
    (deleted rows are walked through, as the beam walks them)."""
    nb = state.nbrs[:n]
    seen = torch.zeros(n, dtype=torch.bool, device=nb.device)
    entry = int(state.entry)
    if not 0 <= entry < n:
        return seen
    front = torch.tensor([entry], device=nb.device)
    seen[front] = True
    while front.numel():
        nxt = nb[front].reshape(-1)
        nxt = torch.unique(nxt[nxt >= 0].long())
        front = nxt[~seen[nxt]]
        seen[front] = True
    return seen


def adopt_unreachable(state: GraphState, linked: torch.Tensor,
                      metric: str) -> int:
    """The port's own repair, which the reference does not make: link
    every linked live row that no walk of level-0 links from the entry
    reaches (no beam finds it but as its start) from a row that is
    reached. Reverse links are pruned by distance, so a row whose every
    selected neighbour kept nearer entrants has no in-link, and rows
    linked only among such rows are cut off with it; many lie in the
    first chunk, which only intra-chunk candidates link, and a refine or
    a vacuum that rewrites rows cuts off more. A lost row joins the row
    of the nearest reached row among its out-neighbours and a beam's M0
    nearest to it that has a free slot, or else takes the place of that
    row's farthest entry with another in-link from a reached row; rows
    reached through it are found again, and a row cut off all the same
    is taken up in the next of at most ADOPT_ROUNDS rounds. `linked` [n]
    bool marks the rows to consider, the first n of the arena. In place;
    returns the rows adopted."""
    n = linked.shape[0]
    adopted = 0
    for _ in range(ADOPT_ROUNDS):
        seen = reached(state, n)
        rows = torch.nonzero(linked & ~seen & ~state.deleted[:n])[:, 0]
        if rows.numel() == 0 or not bool(seen.any()):
            break
        got = _adopt(state, rows, seen, metric)
        adopted += got
        if got == 0:
            break
    return adopted


def _adopt(state: GraphState, rows: torch.Tensor, seen: torch.Tensor,
           metric: str) -> int:
    """One round of `adopt_unreachable` for the lost `rows`."""
    n = seen.shape[0]

    def dists(at: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
        return dist.gathered(state.vectors, ids, state.vectors[at], metric,
                             corpus_norms=state.norms,
                             query_norms=state.norms[at]).cpu().numpy()

    # in-links from reached rows only: an entry that keeps another one
    # stays reached when its place is taken
    nb = state.nbrs[:n][seen]
    indeg = torch.bincount(nb[nb >= 0].long(), minlength=n)
    M0 = nb.shape[1]
    _, found = beam_search(state, state.vectors[rows], state.norms[rows],
                           metric=metric, ef=M0)
    outs = torch.cat([state.nbrs[rows], found], 1)              # [k, 2 M0]
    outs = torch.where(seen[outs.clamp_min(0).long()] & (outs >= 0), outs,
                       -1)
    if not bool((outs >= 0).any()):
        return 0
    out_d = dists(rows, outs)
    hosts = torch.unique(outs[outs >= 0]).long()
    host_rows = state.nbrs[hosts]                               # [h, M0]
    row_of = {a: i for i, a in enumerate(hosts.tolist())}
    ids, ds = host_rows.cpu().numpy(), dists(hosts, host_rows)
    deg = dict(zip(ids[ids >= 0].tolist(),
                   indeg[host_rows[host_rows >= 0].long()].tolist()))
    changed: set[int] = set()
    adopted = 0
    for r, cand, cd in zip(rows.tolist(), outs.cpu().numpy(), out_d):
        for d, j in sorted({(float(d), int(j))
                            for j, d in zip(cand, cd) if j >= 0}):
            i = row_of[j]
            free = np.flatnonzero(ids[i] < 0)
            if free.size:
                slot = int(free[0])
            else:
                keeps = np.array([deg[int(e)] >= 2 for e in ids[i]])
                if not keeps.any():
                    continue
                slot = int(np.flatnonzero(keeps)[np.argmax(ds[i][keeps])])
                deg[int(ids[i, slot])] -= 1
            ids[i, slot], ds[i, slot], deg[r] = r, d, 1
            changed.add(i)
            adopted += 1
            break
    if changed:
        at = sorted(changed)
        state.nbrs[hosts[at]] = torch.from_numpy(ids[at]).to(
            state.nbrs.device)
    return adopted


# ---------------------------------------------------------------------------
# insert pipelines
# ---------------------------------------------------------------------------

def _with_intra(bd, bi, enc, norms, rows, metric: str, intra_k: int):
    """Beam candidates + each row's intra_k nearest rows of its own chunk
    (the chunk's rows are not linked yet, so the beam cannot find them),
    sorted ascending."""
    if intra_k <= 0:
        return bd, bi
    C = rows.shape[0]
    P = dist.pairwise(enc, enc, metric, corpus_norms=norms, query_norms=norms)
    eye = torch.eye(C, dtype=torch.bool, device=rows.device)
    P = torch.where(eye | (rows[None, :] < 0) | (rows[:, None] < 0), INF, P)
    nd, npos = _smallest(P, min(intra_k, C - 1))
    ni = torch.where(torch.isinf(nd), -1, rows[npos])
    all_d, order = torch.sort(torch.cat([bd, nd], 1), dim=1, stable=True)
    return all_d, torch.cat([bi, ni], 1).gather(1, order)


def insert_chunk(state: GraphState, rows: torch.Tensor, enc: torch.Tensor,
                 norms: torch.Tensor, new_levels: torch.Tensor, *,
                 metric: str, ef: int, m: int, intra_k: int,
                 dual: bool = False, expand: int = 8) -> GraphState:
    """Write the chunk's vectors into the arena, then link its rows
    (`link_chunk`, which reads the vectors back as written; padding rows
    come back zeroed, as the reference's callers pad them). Works from
    the empty graph too. In place."""
    write_vectors(state, rows, enc, norms)
    return link_chunk(state, rows, new_levels, metric=metric, ef=ef, m=m,
                      intra_k=intra_k, dual=dual, expand=expand)


def link_chunk(state: GraphState, rows: torch.Tensor,
               new_levels: torch.Tensor, *, metric: str, ef: int, m: int,
               intra_k: int, dual: bool = False,
               expand: int = 8) -> GraphState:
    """Graph-link rows whose vectors are already in the arena: beam
    candidates -> intra-chunk candidates -> select-neighbors -> forward /
    reverse link commit. Works from the empty graph too (the beam finds
    nothing; intra-chunk candidates seed the graph). In place, under the
    profiler range `hnsw.link`; the selection is the span
    `graph.select`."""
    with tracing.kernel_range("hnsw.link"):
        real = rows >= 0
        safe = rows.clamp_min(0).long()
        enc = torch.where(real[:, None], state.vectors[safe], 0)
        norms = state.norms[safe] * real
        bd, bi = beam_search(state, enc, norms, metric=metric, ef=ef,
                             dual=dual, expand=expand)
        all_d, all_i = _with_intra(bd, bi, enc, norms, rows, metric,
                                   intra_k)
        # a staged-but-unlinked row must not select itself
        self_dup = all_i == rows[:, None]
        all_d = torch.where(self_dup, INF, all_d)
        all_i = torch.where(self_dup, -1, all_i)
        with tracing.span("graph.select", n=rows.shape[0]):
            sel_i, sel_d = select_neighbors(state, all_d, all_i, m, metric)
        return commit_chunk(state, rows, sel_i, sel_d, new_levels,
                            metric=metric, m=m)


# ---------------------------------------------------------------------------
# upper-layer exact-KNN maintenance
# ---------------------------------------------------------------------------

def update_upper(state: GraphState, new_nodes: torch.Tensor,
                 new_uidx: torch.Tensor, *, metric: str,
                 top_level: Optional[int] = None) -> GraphState:
    """Insert K new upper nodes into every level-l exact-KNN graph: their
    forward rows are the true top-MU among level >= l nodes; existing rows
    merge the arrivals through the cached distances (up_dists). In place.

    `top_level`, the highest level of any upper node (new ones included),
    bounds the loop: above it no row is at the level, so the reference's
    iterations there change nothing. Default: every level."""
    ucap, LMAX, MU = state.up_nbrs.shape
    dev = new_nodes.device
    keep, r = _real(new_nodes)
    state.up_of[r] = new_uidx[keep]
    keep_u, u = _real(new_uidx)
    state.up_node[u] = new_nodes[keep_u]
    up_node = state.up_node

    # distances new uppers x all uppers: one product
    nn = new_nodes.clamp_min(0).long()
    all_rows = up_node.clamp_min(0).long()
    Dm = dist.pairwise(state.vectors[nn], state.vectors[all_rows], metric,
                       corpus_norms=state.norms[all_rows],
                       query_norms=state.norms[nn])              # [K, ucap]
    occupied = up_node >= 0
    self_mask = new_uidx[:, None] == torch.arange(ucap, device=dev)[None, :]
    Dm = torch.where(occupied[None, :] & ~self_mask, Dm, INF)
    # rows created in this call take the exact forward top-MU; they stay
    # out of the reverse merge
    is_new = torch.zeros(ucap, dtype=torch.bool, device=dev)
    is_new[u] = True
    new_lv = torch.where(new_nodes >= 0, state.levels[nn], -1)
    u_lv = torch.where(occupied, state.levels[all_rows], -1)
    cols_id = torch.where(new_nodes >= 0, new_nodes, -1)

    L = LMAX if top_level is None else min(LMAX, top_level)
    for lvl in range(1, L + 1):
        in_new = new_lv >= lvl                                   # [K]
        in_all = u_lv >= lvl                                     # [ucap]
        Dl = torch.where(in_new[:, None] & in_all[None, :], Dm, INF)
        # forward: top-MU per new node at this level
        nd, npos = _smallest(Dl, MU)
        f_i = torch.where(torch.isinf(nd), -1, up_node[npos])
        tgt = in_new & (new_uidx >= 0)
        t = new_uidx[tgt].long()
        state.up_nbrs[t, lvl - 1] = f_i[tgt]
        state.up_dists[t, lvl - 1] = nd[tgt]
        # reverse: merge the arrivals into existing rows via cached dists
        cols_d = torch.where(in_new[:, None], Dl, INF).T         # [ucap, K]
        cols_i = torch.where(in_new, cols_id, -1)[None, :].expand(ucap, -1)
        row_d = torch.cat([state.up_dists[:, lvl - 1], cols_d], 1)
        row_i = torch.cat([state.up_nbrs[:, lvl - 1], cols_i], 1)
        td, tp = _smallest(row_d, MU)
        mi = torch.where(torch.isinf(td), -1, row_i.gather(1, tp))
        rk = (in_all & occupied & ~is_new)[:, None]
        state.up_nbrs[:, lvl - 1] = torch.where(rk, mi,
                                                state.up_nbrs[:, lvl - 1])
        state.up_dists[:, lvl - 1] = torch.where(rk, td,
                                                 state.up_dists[:, lvl - 1])
    return state


# ---------------------------------------------------------------------------
# refine: re-select rows with the diversity heuristic
# ---------------------------------------------------------------------------

def refine_chunk(state: GraphState, rows: torch.Tensor, *, metric: str,
                 ef: int, m_out: int) -> GraphState:
    """Re-search each row and rewrite its level-0 row with the
    heuristic-selected neighbours of beam(ef) + its current (live)
    neighbours. Rows with nothing selected stay as they are. In place."""
    C = rows.shape[0]
    M0 = state.nbrs.shape[1]
    safe = rows.clamp_min(0).long()
    q = state.vectors[safe]
    qn = state.norms[safe]
    bd, bi = beam_search(state, q, qn, metric=metric, ef=ef, exclude=rows,
                         dual=True)
    cur = state.nbrs[safe]
    cur = torch.where((rows[:, None] >= 0) & (cur != rows[:, None]), cur, -1)
    cur = torch.where(state.deleted[cur.clamp_min(0).long()], -1, cur)
    cd = dist.gathered(state.vectors, cur, q, metric,
                       corpus_norms=state.norms, query_norms=qn)
    dup = _seen(cur, bi)
    all_d = torch.cat([bd, torch.where(dup, INF, cd)], 1)
    all_i = torch.cat([bi, torch.where(dup, -1, cur)], 1)
    all_d, order = torch.sort(all_d, dim=1, stable=True)
    all_i = all_i.gather(1, order)

    sel_i, _ = select_neighbors(state, all_d, all_i, m_out, metric)
    new_rows = torch.full((C, M0), -1, dtype=torch.int32, device=rows.device)
    new_rows[:, :m_out] = sel_i
    tgt = torch.where((sel_i >= 0).any(1), rows, -1)
    keep, r = _real(tgt)
    state.nbrs[r] = new_rows[keep]
    return state
