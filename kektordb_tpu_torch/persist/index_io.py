"""Index (de)serialization for checkpoints, in the layout of
kektordb_tpu/persist/index_io.py: an index's tensors go into the
checkpoint's arrays under "<name>/<leaf>" keys, its host state into a
msgpack-able dict, so either package opens the other's indexes.

Kinds: "hnsw" (the GraphState leaves) and "flat" (the brute-force
arena). A "sharded" checkpoint (per-shard hnsw states and a global id
map) opens as one unsharded index, as the JAX package opens it on a host
with fewer devices than shards: every live vector is added again. Kind
"host" is not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import asdict
from typing import Any

import numpy as np
import torch

from .. import device as devlib
from ..index import hnsw_kernels as K
from ..index.bruteforce import BruteForceIndex
from ..index.hnsw import HNSWConfig, HNSWIndex
from ..ops import quantize as quant

log = logging.getLogger("kektordb.persist")


def _quantizer_state(idx) -> dict[str, Any]:
    return {"abs_max": float(idx.quantizer.abs_max),
            "trained": bool(idx.quantizer.trained)}


def dump_index(idx, name: str, arrays: dict[str, Any]) -> dict[str, Any]:
    """Put the index's tensors into `arrays` and return its host state."""
    if isinstance(idx, BruteForceIndex):
        arrays[f"{name}/vectors"] = idx._vectors
        arrays[f"{name}/norms"] = idx._norms
        arrays[f"{name}/valid"] = idx._valid
        return {
            "kind": "flat",
            "metric": idx.metric, "precision": idx.precision,
            "dim": idx.dim,
            "ext_to_row": dict(idx.ids.ext_to_row),
            "free": list(idx.ids.free),
            "rows": len(idx.ids.row_to_ext),
            "quantizer": _quantizer_state(idx),
        }
    if not isinstance(idx, HNSWIndex):
        raise TypeError(f"cannot checkpoint an index of type {type(idx)}")
    idx._stage_pending()
    for leaf, val in idx.state._asdict().items():
        arrays[f"{name}/{leaf}"] = val
    return {
        "kind": "hnsw",
        "metric": idx.metric, "precision": idx.precision,
        "dim": idx.dim, "config": asdict(idx.config),
        "ext_to_row": dict(idx.ids.ext_to_row),
        "free": list(idx.ids.free),
        "rows": len(idx.ids.row_to_ext),
        "deleted_rows": list(idx._deleted_rows),
        "up_free": list(idx._up_free),
        "up_next": idx._up_next,
        "max_level": idx._max_level,
        "needs_refine": idx.needs_refine,
        "serve_quantized": idx._serve_quantized,
        "refine_cursor": idx._refine_cursor,
        "unlinked": [[int(r), int(lv)] for r, lv in idx._unlinked],
        "quantizer": _quantizer_state(idx),
    }


def cfg_from(st: dict[str, Any]) -> HNSWConfig:
    """HNSWConfig from a checkpoint, dropping the keys this package does
    not know (options of the JAX package that are not ported, or a newer
    build's), with a warning."""
    known = {f.name for f in dataclasses.fields(HNSWConfig)}
    raw = st.get("config") or {}
    unknown = set(raw) - known
    if unknown:
        log.warning("checkpoint: ignoring unknown index config keys %s",
                    sorted(unknown))
    return HNSWConfig(**{k: v for k, v in raw.items() if k in known})


def _row_to_ext(st: dict[str, Any]) -> list:
    row_to_ext = [None] * st["rows"]
    for e, r in st["ext_to_row"].items():
        row_to_ext[r] = e
    return row_to_ext


def load_index(st: dict[str, Any], arrays: dict[str, torch.Tensor],
               name: str, device="cuda"):
    """The index that `dump_index` (of either package) described, with its
    tensors on `device`."""
    kind = st.get("kind", "hnsw")
    if kind == "sharded":
        log.warning("checkpoint index %s was saved with shards=%s; loading "
                    "it as one unsharded index (the graph is rebuilt once)",
                    name, st["n_shards"])
        return _merge_sharded_to_single(st, arrays, name, device)
    if kind == "host":
        raise NotImplementedError(
            f"checkpoint index {name!r} is of kind 'host' "
            "(index/hostarena), which is not ported yet "
            "(ROADMAP.md, queue 1, item 10)")
    q = st["quantizer"]
    if kind == "flat":
        idx = BruteForceIndex(st["dim"], st["metric"], st["precision"],
                              device=device)
        idx._vectors = devlib.from_numpy(arrays[f"{name}/vectors"],
                                         idx.device)
        idx._norms = devlib.from_numpy(arrays[f"{name}/norms"], idx.device)
        idx._valid = arrays[f"{name}/valid"].numpy().astype(bool)
        idx._cap = idx._vectors.shape[0]
        idx.ids.ext_to_row = dict(st["ext_to_row"])
        idx.ids.row_to_ext = _row_to_ext(st)
        idx.ids.free = list(st["free"])
        idx.ids.rebuild_mask()
        idx.quantizer = quant.QuantizerState(
            torch.tensor(float(q["abs_max"]), device=idx.device),
            bool(q["trained"]))
        return idx
    leaves = {f: arrays[f"{name}/{f}"] for f in K.GraphState._fields}
    serve_q = bool(st.get("serve_quantized", False))
    if st["metric"] == "euclidean" and not serve_q \
            and leaves["vectors"].dtype != torch.int8:
        # norms hold |x|^2 of the stored values for the L2 serving bias;
        # recomputed, so checkpoints written before that convention load
        leaves["norms"] = torch.sum(leaves["vectors"].float() ** 2, dim=-1)
    return HNSWIndex.from_reference_state(
        leaves,
        {"row_to_ext": _row_to_ext(st), "ext_to_row": st["ext_to_row"],
         "free": st["free"]},
        cfg_from(st), metric=st["metric"], precision=st["precision"],
        device=device,
        mirrors={"deleted_rows": st["deleted_rows"],
                 "max_level": st["max_level"],
                 "up_free": st["up_free"], "up_next": st["up_next"],
                 "unlinked": st.get("unlinked") or [],
                 "refine_cursor": st.get("refine_cursor", 0),
                 "needs_refine": st["needs_refine"],
                 "serve_quantized": serve_q,
                 "abs_max": q["abs_max"] if q["trained"] else None})


def _merge_sharded_to_single(st: dict[str, Any],
                             arrays: dict[str, torch.Tensor], name: str,
                             device):
    """Fold a sharded checkpoint into one HNSWIndex by adding every live
    vector again (the data lives in the per-shard arenas, so nothing is
    lost; the graph is rebuilt once). A shard that served int8 makes the
    merged index serve int8 too."""
    idx = HNSWIndex(st["dim"], st["metric"], st["precision"], cfg_from(st),
                    device=device)
    serve_q = False
    for j, sst in enumerate(st["shards"]):
        sh = load_index(sst, arrays, f"{name}/s{j}", device)
        serve_q = serve_q or sh._serve_quantized
        ids, vecs = [], []
        for ext in sh.ids.ext_to_row:
            v = sh.get_vector(ext)   # dequantized f32 for int8 arenas
            if v is None:
                continue
            ids.append(ext)
            vecs.append(v)
        if ids:
            idx.add_batch(ids, np.stack(vecs))
    if serve_q and idx.precision != "int8":
        idx.compress_serving("int8")
    return idx
