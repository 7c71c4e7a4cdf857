"""Device-side hybrid fusion epilogue, the PyTorch port of
kektordb_tpu/ops/fuse.py.

Reference semantics: searchWithFusion's min-max normalize + weighted-sum
fusion over the union of the vector and BM25 candidate sets
(ops.go:1071-1097, search_utils.go:48-72), with the agent-memory time
decay (ops.go:1100-1186). The host path (engine._assemble_fused) computes
the same in float64 numpy; this module chains it onto the scan's device
tensors instead, so a hybrid or decayed search ends in one device-to-host
copy (scan -> fuse -> top-k -> one copy).

The reference's `_fuse_topk` is XLA, not a Pallas kernel; here it is torch
ops. Its tie order is `lax.top_k`'s (the lower index first), which a
stable descending `torch.sort` keeps.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing

INF = float("inf")

# rows sentinel for text-candidate padding: larger than any row index, so
# the padded tail stays sorted for searchsorted and never matches a real
# scan row
_PAD_ROW = np.iinfo(np.int32).max


class DecayDevice(NamedTuple):
    """Device-resident per-row decay spec (the columnar mirror of
    search_utils.go:91-141 semantics, layer config resolved on the host).

    The three channels (ref timestamp, 1/half_life, model id) are packed
    into one [cap, 4] f32 tensor, so the epilogue reads the spec of its
    [B, F+T] candidate rows with one row gather.

    Timestamps are stored relative to `epoch` so f32 keeps ~ms precision:
    absolute unix seconds (~1.8e9) carry only ~2-minute f32 resolution.
    The engine rebuilds the mirror when `now - epoch` grows past a few
    hours, and on any decay mutation (DecayColumns.version)."""
    epoch: float
    packed: torch.Tensor   # [cap, 4] f32: ref_rel | invhl | model | pad
    #                        (ref_rel 0 + invhl 0 where inactive)


def _layer_tables(cols, cfg):
    """(half_life, model_id) lookup tables indexed by layer id; the last
    slot holds the index-level defaults (layer -1 / unknown)."""
    from ..engine.fusion import _MODEL_IDS

    n_layers = len(cols.layer_names)
    hl_by_layer = np.full(n_layers + 1, cfg.decay_half_life)
    model_by_layer = np.full(n_layers + 1,
                             _MODEL_IDS.get(cfg.decay_model, 0), np.int8)
    for i, name in enumerate(cols.layer_names):
        lc = cfg.layers.get(name)
        if lc is None:
            continue
        if lc.decay_half_life > 0:
            hl_by_layer[i] = lc.decay_half_life
        if lc.decay_model:
            model_by_layer[i] = _MODEL_IDS.get(lc.decay_model, 0)
    return hl_by_layer, model_by_layer


def _pack_rows(cols, cfg, rows: np.ndarray, epoch: float) -> np.ndarray:
    """[len(rows), 4] packed spec rows (ref_rel | invhl | model | pad) -
    the per-row semantics of the mirror for arbitrary row indices.
    Inactive rows (pinned / no timestamp / half_life<=0 / beyond the
    column cap) get invhl=0, which yields factor 1.0 under every model."""
    r = np.asarray(rows, np.int64)
    if cols.cap == 0:                     # no memory metadata anywhere
        packed = np.zeros((r.size, 4), np.float32)
        packed[:, 2] = _layer_tables(cols, cfg)[1][-1]   # default model
        return packed
    inb = r < cols.cap
    safe = np.where(inb, r, 0)
    ref64 = np.where(inb & np.isnan(cols.accessed[safe]),
                     cols.created[safe], cols.accessed[safe])
    ref64 = np.where(inb, ref64, np.nan)
    active = ~np.isnan(ref64)
    active &= ~(inb & cols.pinned[safe])

    hl_by_layer, model_by_layer = _layer_tables(cols, cfg)
    n_layers = len(cols.layer_names)
    lid = np.where(inb & (cols.layer[safe] >= 0),
                   cols.layer[safe], n_layers).astype(np.int64)
    hl = hl_by_layer[lid]
    model = model_by_layer[lid]
    active &= hl > 0

    count = np.where(inb, cols.count[safe].astype(np.float64), 0.0)
    s = np.where(model == 3,
                 hl * (1.0 + np.log1p(np.maximum(count, 0.0))),
                 hl)
    invhl = np.where(active & (s > 0), 1.0 / np.where(s > 0, s, 1.0), 0.0)
    ref_rel = np.where(active, ref64 - epoch, 0.0)
    packed = np.zeros((r.size, 4), np.float32)
    packed[:, 0] = ref_rel
    packed[:, 1] = invhl
    packed[:, 2] = model
    return packed


def build_decay_device(cols, cfg, cap: int, device) -> DecayDevice:
    """Reduce DecayColumns + MemoryConfig to the packed device mirror: one
    vectorized host pass and one upload, kept by the engine until the next
    decay mutation (which then updates it with update_decay_device)."""
    build_decay_device.calls += 1
    epoch = time.time()
    packed = _pack_rows(cols, cfg, np.arange(cap, dtype=np.int64), epoch)
    return DecayDevice(epoch=epoch,
                       packed=torch.from_numpy(packed).to(device))


def update_decay_device(dd: DecayDevice, cols, cfg, rows) -> DecayDevice:
    """Incremental mirror refresh: recompute the spec of `rows` only and
    copy it into the device tensor in place (`index_copy_`), instead of an
    O(cap) host pass and a full upload. This keeps the agent-memory
    reinforce-on-read pattern cheap: every reinforce dirties one row
    (metadata.DecayColumns.dirty). Rows take the mirror's epoch, so
    ref_rel stays in one time base.

    In place, where the reference builds a new array: a search that still
    holds the mirror then reads the refreshed rows, the spec of writes
    already committed to the host columns."""
    update_decay_device.calls += 1
    r = np.unique(np.asarray(list(rows), np.int64))
    cap = dd.packed.shape[0]
    r = r[(r >= 0) & (r < cap)]
    if r.size == 0:
        return dd
    sub = _pack_rows(cols, cfg, r, dd.epoch)
    dev = dd.packed.device
    dd.packed.index_copy_(0, torch.from_numpy(r).to(dev),
                          torch.from_numpy(sub).to(dev))
    return dd


build_decay_device.calls = 0
update_decay_device.calls = 0


def _decay_factor(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The decay multiplier by model id (fusion._MODEL_IDS): 1 linear,
    2 step, 3 ebbinghaus, else (0) exponential, 0.5**x = exp2(-x).
    Inactive rows have invhl = 0, so x = 0 and the factor is 1 under
    every model."""
    return torch.where(
        m == 1.0, torch.clamp_min(1.0 - 0.5 * x, 0.0),
        torch.where(m == 2.0, torch.where(x < 1.0, 1.0, 0.5),
                    torch.where(m == 3.0, torch.exp(-x), torch.exp2(-x))))


def _fuse_topk(d, rows, tr, tsn, alpha, scale, k: int, decay=None,
               now_rel=None):
    """d [B, F] f32 distances (inf-masked), rows [B, F] int32 (-1 pads),
    tr [T] int32 ascending text-candidate rows (_PAD_ROW pads),
    tsn [T] f32 normalized text scores (0 at pads), alpha and scale f32
    scalars. decay: optional packed [cap, 4] DecayDevice tensor + now_rel
    (f32 seconds relative to the mirror's epoch), the per-row time-decay
    multiplier. Returns (fused scores [B, kk] descending, rows [B, kk]
    int32, distances [B, kk]), kk = min(k, F + T)."""
    B, F = d.shape
    T = tr.shape[0]
    valid = rows >= 0
    # min-max normalize the vector branch per query (invert: lower
    # distance -> higher similarity), exactly the host-path math
    lo = torch.where(valid, d, INF).amin(dim=1, keepdim=True)
    hi = torch.where(valid, d, -INF).amax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1, keepdim=True)
    lo = torch.where(any_valid, lo, 0.0)
    hi = torch.where(any_valid, hi, 0.0)
    span = hi - lo
    ok = span > 0
    vec_sim = torch.where(ok, (hi - d) / torch.where(ok, span, 1.0), 1.0)

    # text score of each vector candidate: sorted lookup into tr
    pos = torch.clamp(torch.searchsorted(tr, rows), 0, T - 1)
    tmatch = valid & (tr[pos] == rows)
    text_of_vec = torch.where(tmatch, tsn[pos], 0.0)
    # text-only candidates already in the query's vector set are
    # duplicates: mark the matched positions (O(B*F)); unmatched entries
    # write to a spare column T that is dropped
    dup = torch.zeros((B, T + 1), dtype=torch.bool, device=d.device)
    dup.scatter_(1, torch.where(tmatch, pos, T).long(), True)
    dup = dup[:, :T]
    live_t = tr < _PAD_ROW

    zeros = torch.zeros((B, T), dtype=d.dtype, device=d.device)
    vec_all = torch.cat([torch.where(valid, vec_sim, 0.0), zeros], dim=1)
    text_all = torch.cat([text_of_vec, tsn.expand(B, T)], dim=1)
    fused = alpha * vec_all + (1.0 - alpha) * text_all
    keep = torch.cat([valid, ~dup & live_t[None, :]], dim=1)
    fused = torch.where(keep, fused, -INF)

    R_all = torch.cat([rows, tr.expand(B, T)], dim=1)
    if decay is not None:
        cap = decay.shape[0]
        safe = torch.clamp(R_all, 0, cap - 1).long()   # pads are -inf
        spec = decay[safe]                              # one gather [B,C,4]
        x = torch.clamp_min(now_rel - spec[..., 0], 0.0) * spec[..., 1]
        factor = _decay_factor(x, spec[..., 2])
        fused = torch.where(torch.isfinite(fused), fused * factor, fused)
    d_all = torch.cat([torch.where(valid, d, INF),
                       torch.full((B, T), INF, device=d.device)], dim=1)
    kk = min(k, F + T)
    top_sc, top_i = torch.sort(fused, dim=1, descending=True, stable=True)
    top_sc, top_i = top_sc[:, :kk], top_i[:, :kk]
    top_rows = torch.gather(R_all, 1, top_i).int()
    top_d = torch.gather(d_all, 1, top_i) * scale
    return top_sc, top_rows, top_d


def prepare_text(text_rows: np.ndarray, text_vals: np.ndarray,
                 cap_t: int) -> tuple[np.ndarray, np.ndarray]:
    """Host prep: keep the top cap_t text candidates, min-max normalize
    their scores (search_utils.go:48-55), sort by row, pad to a power of
    two (>= 64) with _PAD_ROW."""
    if text_rows.size == 0:
        # vector-only call routed through the fused epilogue (decay-on
        # path): an all-pad text block contributes nothing
        return (np.full(64, _PAD_ROW, np.int32), np.zeros(64, np.float32))
    if text_rows.size > cap_t:
        sel = np.argpartition(text_vals, text_vals.size - cap_t)[-cap_t:]
        tr, ts = text_rows[sel], text_vals[sel]
    else:
        tr, ts = text_rows, text_vals
    t_lo, t_hi = ts.min(), ts.max()
    tsn = np.ones_like(ts) if t_hi <= t_lo else (ts - t_lo) / (t_hi - t_lo)
    order = np.argsort(tr, kind="stable")
    tr, tsn = tr[order], tsn[order]
    T = 64
    while T < tr.size:
        T *= 2
    pad = T - tr.size
    if pad:
        tr = np.concatenate([tr, np.full(pad, _PAD_ROW, np.int64)])
        tsn = np.concatenate([tsn, np.zeros(pad)])
    return tr.astype(np.int32), tsn.astype(np.float32)


def fused_topk(d_dev, rows_dev, text_rows: np.ndarray,
               text_vals: np.ndarray, alpha: float, k: int,
               scale: float, cap_t: int,
               decay_dev: Optional[DecayDevice] = None,
               now: Optional[float] = None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full hybrid epilogue: text prep on the host (the BM25 candidate
    list is shared by the whole batch: a few hundred rows), fusion, decay
    and top-k on the device chained onto the scan outputs, then one
    device-to-host copy of the three results (rows travel bit-cast as
    f32). Counts its calls in `fused_topk.calls`."""
    fused_topk.calls += 1
    with tracing.kernel_range("fuse.fused_topk"):
        dev = d_dev.device
        tr, tsn = prepare_text(text_rows, text_vals, cap_t)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)
        dec = now_rel = None
        if decay_dev is not None:
            dec = decay_dev.packed
            now_rel = f32((now if now is not None else time.time())
                          - decay_dev.epoch)
        sc, rw, dd = _fuse_topk(d_dev.float().contiguous(),
                                rows_dev.int().contiguous(),
                                torch.from_numpy(tr).to(dev),
                                torch.from_numpy(tsn).to(dev), f32(alpha),
                                f32(scale), k, decay=dec, now_rel=now_rel)
        out = torch.stack([sc, rw.view(torch.float32), dd]).cpu().numpy()
        return out[0], out[1].view(np.int32), out[2]


fused_topk.calls = 0
