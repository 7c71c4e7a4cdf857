"""Process-boot half of the multi-process surface: the PyTorch port of
kektordb_tpu/distboot.py.

`init_distributed` joins (or forms) a torch.distributed process group
from the coordinator address, the process count and this process's rank,
as the CLI's `--coordinator / --num-processes / --process-id` flags (or
the KEKTOR_COORDINATOR / KEKTOR_NUM_PROCESSES / KEKTOR_PROCESS_ID
variables) give them:

    from kektordb_tpu_torch.distboot import init_distributed
    init_distributed("host0:1234", num_processes=2, process_id=rank)
    from kektordb_tpu_torch.parallel import ReplicatedServing

The collective backend follows one rule (`backend_for`), decided before
the group forms and never by catching a failure:
  * gloo for ranks on the CPU;
  * gloo for ranks that share a card (more ranks than cards): NCCL does
    not put two ranks on one GPU, so their [B/R, k] tops are staged
    through host memory;
  * NCCL where each rank has a card of its own (rank r on cuda:r).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist

from . import device as devlib


def backend_for(device, world_size: int) -> str:
    """"gloo" or "nccl" for `world_size` ranks on `device` (see above)."""
    dev = torch.device(device)
    if dev.type != "cuda" or world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def rank_device(device, rank: int) -> torch.device:
    """Rank `rank`'s device: the CPU, or card rank % cards (every rank on
    cuda:0 when they share one card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda", timeout_s: float = 300.0) -> bool:
    """Join the process group of `num_processes` ranks whose rank 0
    listens at `coordinator` ("host:port"); each argument left None is
    read from KEKTOR_COORDINATOR / KEKTOR_NUM_PROCESSES /
    KEKTOR_PROCESS_ID. `device` ("cuda" by default, or "cpu") picks the
    backend. Returns True when more than one process takes part.
    Idempotent: an existing group is reported, not re-formed. A wrong
    address or a peer that never comes raises after `timeout_s`."""
    if tdist.is_initialized():
        return tdist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("KEKTOR_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("KEKTOR_NUM_PROCESSES") or 0)
    if process_id is None:
        process_id = int(os.environ.get("KEKTOR_PROCESS_ID") or -1)
    if not coordinator or num_processes < 1 \
            or not 0 <= process_id < num_processes:
        raise ValueError(
            "a process group needs the coordinator address (host:port), "
            "the number of processes and this process's id in "
            f"[0, num_processes); got coordinator={coordinator!r}, "
            f"num_processes={num_processes}, process_id={process_id}")
    dev = devlib.resolve(device)
    backend = backend_for(dev, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(dev, process_id))
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return num_processes > 1
