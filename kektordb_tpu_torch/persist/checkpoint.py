"""Checkpoint store: atomic generations of dense arrays + host state, in
the format of kektordb_tpu/persist/checkpoint.py, so either package opens
the other's checkpoints.

Reference analogue: the gob-encoded `.kdb` snapshot of the whole DB
(core.go:85-302, SaveSnapshot recovery.go:459-558). Tensors go to one
.npz, host state (id maps, metadata, graph, KV) to msgpack. A `CURRENT`
file names the live generation and is swapped atomically once the
generation is fully written and fsynced, so a crash mid-save leaves the
previous checkpoint intact.

The disk boundary is here: `save` takes tensors (on any device) or numpy
arrays and writes numpy; `load` returns CPU tensors. bfloat16 has no npz
dtype, so a bf16 tensor is stored as its 16-bit pattern (uint16) under
the key "<k>::bf16" and viewed back on load.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Optional

import msgpack
import numpy as np
import torch

log = logging.getLogger("kektordb.checkpoint")

CURRENT = "CURRENT"
_BF16 = "::bf16"


def _pack_default(o):
    if isinstance(o, (set, frozenset)):
        return {"__set__": list(o)}
    if isinstance(o, tuple):
        return list(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError(f"cannot pack {type(o)}")


def _unpack_hook(o):
    if "__set__" in o and len(o) == 1:
        return set(o["__set__"])
    return o


def pack_state(state: dict[str, Any]) -> bytes:
    return msgpack.packb(state, default=_pack_default, use_bin_type=True)


def unpack_state(data: bytes) -> dict[str, Any]:
    return msgpack.unpackb(data, raw=False, strict_map_key=False,
                           object_hook=_unpack_hook)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(root: str, arrays: dict[str, Any], state: dict[str, Any]) -> str:
    """Write a new checkpoint generation and swap CURRENT atomically.

    The data files and the generation and root directories are fsynced
    before CURRENT is swapped, so after a power loss CURRENT never names a
    torn generation."""
    os.makedirs(root, exist_ok=True)
    gen = f"ckpt-{int(time.time() * 1000):016d}"
    tmp = os.path.join(root, gen + ".tmp")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **encode_arrays(arrays))
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(pack_state(state))
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    final = os.path.join(root, gen)
    os.replace(tmp, final)
    _fsync_dir(root)
    cur_tmp = os.path.join(root, CURRENT + ".tmp")
    with open(cur_tmp, "w") as f:
        f.write(gen)
        f.flush()
        os.fsync(f.fileno())
    os.replace(cur_tmp, os.path.join(root, CURRENT))
    _fsync_dir(root)
    _gc(root, keep=2)
    return final


def encode_arrays(arrays: dict[str, Any]) -> dict[str, np.ndarray]:
    """Tensors and arrays -> the numpy arrays the npz holds (bf16 tensors
    as uint16 under "<k>::bf16")."""
    out = {}
    for k, a in arrays.items():
        if not isinstance(a, torch.Tensor):
            out[k] = np.asarray(a)
            continue
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[k + _BF16] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[k] = t.numpy()
    return out


def decode_arrays(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The npz's arrays -> CPU tensors. A raw 2-byte void array (a
    checkpoint written before the bf16 key existed) can only be bf16."""
    out = {}
    for k, a in arrays.items():
        if k.endswith(_BF16):
            out[k[: -len(_BF16)]] = torch.from_numpy(
                a.view(np.int16)).view(torch.bfloat16)
        elif a.dtype.kind == "V" and a.dtype.itemsize == 2:
            out[k] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a)
    return out


def _load_gen(root: str, gen: str
              ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    path = os.path.join(root, gen)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = decode_arrays({k: z[k] for k in z.files})
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        state = unpack_state(f.read())
    return arrays, state


def load(root: str
         ) -> Optional[tuple[dict[str, torch.Tensor], dict[str, Any]]]:
    """Load the CURRENT generation; on a torn or corrupt one, fall back to
    the newest older generation that parses (loudly: that is a rollback
    of the database)."""
    cur = os.path.join(root, CURRENT)
    if not os.path.exists(cur):
        return None
    with open(cur) as f:
        gen = f.read().strip()
    older = sorted((d for d in os.listdir(root)
                    if d.startswith("ckpt-") and not d.endswith(".tmp")
                    and d != gen), reverse=True)
    for g in [gen] + older:
        try:
            return _load_gen(root, g)
        except Exception as exc:
            log.warning("checkpoint generation %s failed to load (%s); "
                        "falling back to an older generation", g, exc)
    return None


def _gc(root: str, keep: int) -> None:
    """Drop all but the newest `keep` generations (never the CURRENT one)."""
    try:
        with open(os.path.join(root, CURRENT)) as f:
            current = f.read().strip()
    except FileNotFoundError:
        return
    gens = sorted(d for d in os.listdir(root)
                  if d.startswith("ckpt-") and not d.endswith(".tmp"))
    for d in gens[:-keep]:
        if d != current:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
