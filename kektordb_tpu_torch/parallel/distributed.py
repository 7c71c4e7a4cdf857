"""Replicated serving: the PyTorch port of
kektordb_tpu/parallel/distributed.py.

Two axes, as in the reference:
  * the shard axis: a ShardedHNSW row-shards its arena over the devices
    of ONE process and merges the shards' [B, k] tops (sharded.py);
  * the replica axis: every process (a rank of a torch.distributed
    group, distboot.init_distributed) holds a FULL copy of the index; a
    query batch is split over the replicas, each answers its slice from
    its own copy, and one all_gather of the [B/R, k] tops gives every rank
    the whole batch. Only final tops cross between processes, never
    arenas.

In one process (no group) the replica grid is R x S of the visible
devices (`replica_mesh`): replica r is a copy of the index on row r's
devices, made when the index changed, and the batch is split over the
copies the same way. A row whose devices are the index's own (the
device-repeat setting makes every row the same device) serves from the
index itself.

Collectives run on the backend distboot chose: gloo gathers CPU tensors
(CPU ranks, and ranks that share a card, whose tops are staged through
host memory), NCCL gathers them on each rank's card.
"""

from __future__ import annotations

import copy
import zlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from .. import device as devlib
from .. import distboot
from ..distboot import init_distributed  # noqa: F401
from ..index import hnsw_kernels as K
from ..ops import distance as dist
from ..ops import quantize as quant
from . import sharded as shlib


def _world() -> tuple[int, int]:
    """(world size, rank); (1, 0) without a process group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def _rank_devices(rank: int, device) -> list[torch.device]:
    """The devices rank `rank` shards over in a process group: its own
    device (distboot.rank_device), repeated by the device-repeat
    setting."""
    return [distboot.rank_device(devlib.resolve(device), rank)] \
        * max(devlib.device_repeat(), 1)


def replica_mesh(n_replicas: Optional[int] = None,
                 device="cuda") -> list[list[torch.device]]:
    """The R x S serving grid: row r = replica r's devices. In a process
    group R is the number of ranks and row r is rank r's devices. In one
    process the visible devices are split into `n_replicas` rows."""
    world, _ = _world()
    if world > 1:
        if n_replicas not in (None, world):
            raise ValueError("the replica count of a process group is its "
                             f"size, {world}")
        return [_rank_devices(r, device) for r in range(world)]
    devs = devlib.visible_devices(device)
    R = n_replicas or 1
    if len(devs) % R:
        raise ValueError(f"{len(devs)} devices don't factor into "
                         f"{R} replicas")
    S = len(devs) // R
    return [devs[r * S:(r + 1) * S] for r in range(R)]


def local_shard_mesh(mesh: Sequence[Sequence]) -> list[torch.device]:
    """This process's row of the grid: the mesh its ShardedHNSW is built
    on (row 0 in one process)."""
    _, rank = _world()
    return [torch.device(d) for d in mesh[rank]]


def _shard_copy(s, dev: torch.device):
    """An HNSWIndex that shares `s`'s host maps, with its device state
    copied to `dev` (serving only: written through the original)."""
    if s.device == dev:
        return s
    c = copy.copy(s)
    c.device = dev
    c._state = K.GraphState(*(t.to(dev) for t in s.state))
    c.quantizer = quant.QuantizerState(s.quantizer.abs_max.to(dev),
                                       s.quantizer.trained)
    c._proj = None
    c._proj_version = -1
    c._proj_basis = None if s._proj_basis is None \
        else s._proj_basis.to(dev)
    return c


def _replica_copy(sh: "shlib.ShardedHNSW", devs: Sequence[torch.device]):
    if list(devs) == sh.mesh:
        return sh
    c = copy.copy(sh)
    c.mesh = list(devs)
    c.shards = [_shard_copy(s, d) for s, d in zip(sh.shards, devs)]
    c.device = c.shards[0].device
    c._rev_cache = [None] * sh.n_shards
    c._rev_all = None
    c._fp_cache = None
    return c


class ReplicatedServing:
    """Replicated serving over a local ShardedHNSW. In a process group
    every rank must call search() and verify_replicas() together, with the
    same arguments, after the same writes (deterministic replication:
    same journal, same state)."""

    def __init__(self, sharded: "shlib.ShardedHNSW",
                 mesh: Optional[Sequence[Sequence]] = None,
                 n_replicas: Optional[int] = None):
        self.sharded = sharded
        self.mesh = [list(map(torch.device, row)) for row in
                     (mesh if mesh is not None
                      else replica_mesh(n_replicas, sharded.device))]
        R, S = len(self.mesh), len(self.mesh[0])
        if S != sharded.n_shards:
            raise ValueError(f"mesh shard axis {S} != sharded.n_shards "
                             f"{sharded.n_shards}")
        world, rank = _world()
        self._multi = world > 1
        if self._multi:
            if R != world:
                raise ValueError(f"{R} replica rows for {world} ranks")
            if self.mesh[rank] != sharded.mesh:
                raise ValueError(
                    "sharded.mesh does not match this rank's replica-mesh "
                    "row; build the ShardedHNSW with "
                    "mesh=local_shard_mesh(replica_mesh(...))")
        self._copies = None
        self._copies_key = None

    @property
    def n_replicas(self) -> int:
        return len(self.mesh)

    def _replicas(self) -> list:
        """One process: the R copies, remade after a write."""
        sh = self.sharded
        key = (tuple(s._version for s in sh.shards), sh._rev_version)
        if self._copies is None or self._copies_key != key:
            self._copies = [_replica_copy(sh, row) for row in self.mesh]
            self._copies_key = key
        return self._copies

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """all_gather over the ranks, concatenated on dim 0 (CPU tensors
        on gloo, the rank's card on NCCL)."""
        if tdist.get_backend() == "gloo":
            t = t.cpu()
        out = [torch.empty_like(t) for _ in range(self.n_replicas)]
        tdist.all_gather(out, t.contiguous())
        return torch.cat(out)

    def search(self, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """(dists [B, k], global rows [B, k]): the scan read, the batch
        split over the replicas. B is padded as the reference pads it: to
        R * 16 (R * 32 for int8 arenas), doubled until it holds B."""
        sh = self.sharded
        queries = sh._queries(queries)
        B = queries.shape[0]
        if len(sh.ids) == 0:
            return (np.full((B, k), np.inf, np.float32),
                    np.full((B, k), -1, np.int32))
        sh.settle_for_serving()
        R = self.n_replicas
        min_b = 32 if sh.shards[0].state.vectors.dtype == torch.int8 else 16
        Bp = R * min_b
        while Bp < B:
            Bp *= 2
        if Bp != B:
            queries = np.concatenate(
                [queries, np.zeros((Bp - B, queries.shape[1]), np.float32)])
        per = Bp // R
        if self._multi:
            _, rank = _world()
            d, sid, row = sh._tops(queries[rank * per:(rank + 1) * per], k,
                                   ef=None, allow_rows=None, use_scan=True)
            d, sid, row = self._gather(d), self._gather(sid), \
                self._gather(row)
        else:
            outs = [c._tops(queries[r * per:(r + 1) * per], k, ef=None,
                            allow_rows=None, use_scan=True)
                    for r, c in enumerate(self._replicas())]
            d, sid, row = (torch.cat([o[i].to(sh.device) for o in outs])
                           for i in range(3))
        d = d[:B].cpu().numpy()
        sid = sid[:B].cpu().numpy()
        row = row[:B].cpu().numpy()
        if sh._serve_quantized and sh.metric == dist.L2 \
                and sh.config.int8_symmetric:
            quantum = float(sh.shards[0].quantizer.abs_max) / 127.0
            d = d * (quantum * quantum)
        valid = (row >= 0) & (row < sh._rev.shape[1])
        gids = np.where(valid,
                        sh._rev[np.where(valid, sid, 0),
                                np.where(valid, row, 0)],
                        -1).astype(np.int32)
        return d, gids

    def search_ids(self, queries: np.ndarray, k: int):
        """(ext_id, dist) per query."""
        d, gids = self.search(queries, k)
        sh = self.sharded
        out = []
        for b in range(gids.shape[0]):
            hits = []
            for j in range(gids.shape[1]):
                g = int(gids[b, j])
                if g >= 0:
                    ext = sh.ids.row_to_ext[g]
                    if ext is not None:
                        hits.append((ext, float(d[b, j])))
            out.append(hits)
        return out

    # -- lifecycle / health --------------------------------------------------

    def search_local(self, queries: np.ndarray, k: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """This replica alone, with no collective: every replica holds the
        whole index, so its answers are the group's. The degraded mode
        while a peer is down (a collective would wait on it)."""
        return self.sharded.search(queries, k)

    def local_fingerprint(self) -> np.ndarray:
        """This replica's [S, n_leaves, 2] state checksum."""
        self.sharded.settle_for_serving()
        return self.sharded.fingerprint()

    def verify_replicas(self) -> dict:
        """Every replica's fingerprint, gathered and compared (collective
        in a process group). {"equal", "replicas", "fingerprint_crc32"},
        the crc being this replica's."""
        fp = self.local_fingerprint()
        flat = np.ascontiguousarray(fp, np.float32).reshape(1, -1)
        if self._multi:
            t = torch.from_numpy(flat)
            if tdist.get_backend() == "nccl":
                t = t.to(self.sharded.device)
            all_fp = self._gather(t).cpu().numpy()
        else:
            all_fp = np.stack([c.fingerprint().reshape(-1)
                               for c in self._replicas()])
        return {
            "equal": bool(np.all(all_fp == all_fp[0])),
            "replicas": self.n_replicas,
            "fingerprint_crc32": zlib.crc32(flat.tobytes()) & 0xffffffff,
        }
