"""Distances, the PyTorch port of kektordb_tpu/ops/distance.py.

Every distance is a blocked batched product, queries [B, D] x corpus
[N, D]^T, in the precision families of the reference:

  f32   : squared euclidean, cosine as 1 - dot on normalized vectors;
          full float32 (TF32 is off, see ..device)
  bf16  : squared euclidean; bf16 operands, float32 accumulation
  int8  : dot in the integer domain with int-domain norms; exact

torch gives `bf16 @ bf16` a bf16 result, so bf16 operands are widened to
float32 first (bf16 values and their products are exact in float32, so
this is a bf16 product with float32 accumulation). CUDA has no integer
matrix product: integer dots are taken elementwise in int32, or as a
float64 product where a matrix product is needed (both exact).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import device as _device  # noqa: F401  (TF32 off)
from .. import native, tracing

# Metrics and precisions: the same names as the reference
L2 = "euclidean"
COSINE = "cosine"
METRICS = (L2, COSINE)

F32 = "float32"
BF16 = "bfloat16"
INT8 = "int8"
PRECISIONS = (F32, BF16, INT8)

INVALID = -1       # pads id arrays; never a valid row

INF = float("inf")


def storage_dtype(precision: str) -> torch.dtype:
    return _device.DTYPES[precision]


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize; zero vectors stay zero."""
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return (x32 / torch.clamp_min(n, eps)).to(x.dtype)


def int_dots(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] integer codes -> exact [B, N] float32 dots. The
    product runs in float64 on the card (no integer matmul there; every
    partial sum of int8 products is an integer far below 2^53) and in
    int32 on the CPU."""
    if corpus.is_cuda:
        return (q.double() @ corpus.double().T).float()
    return (q.int() @ corpus.int().T).float()


def pairwise(
    queries: torch.Tensor,       # [B, D] f32 (or int8 for INT8 precision)
    corpus: torch.Tensor,        # [N, D] storage dtype
    metric: str,
    *,
    corpus_norms: Optional[torch.Tensor] = None,   # [N] int-domain (int8)
    query_norms: Optional[torch.Tensor] = None,    # [B] (int8)
) -> torch.Tensor:
    """Dense [B, N] f32 distances. L2 is squared euclidean; cosine assumes
    normalized inputs and returns 1 - dot."""
    if corpus.dtype == torch.int8:
        dots = int_dots(queries.to(torch.int8), corpus)
        if metric == COSINE:
            qn = query_norms[:, None]
            cn = torch.clamp_min(corpus_norms[None, :], 1e-9)
            return 1.0 - dots / (torch.clamp_min(qn, 1e-9) * cn)
        q2 = (query_norms ** 2)[:, None]
        c2 = (corpus_norms ** 2)[None, :]
        return q2 - 2.0 * dots + c2
    if corpus.dtype == torch.bfloat16:
        dots = queries.to(torch.bfloat16).float() @ corpus.float().T
    else:
        dots = queries.float() @ corpus.float().T
    if metric == COSINE:
        return 1.0 - dots
    q2 = torch.sum(queries.float() ** 2, dim=-1)[:, None]
    c2 = torch.sum(corpus.float() ** 2, dim=-1)[None, :]
    return q2 - 2.0 * dots + c2


def gathered(
    vectors: torch.Tensor,       # [N_cap, D] storage dtype
    ids: torch.Tensor,           # [B, C] int row ids (INVALID-padded)
    queries: torch.Tensor,       # [B, D] query dtype
    metric: str,
    *,
    corpus_norms: Optional[torch.Tensor] = None,
    query_norms: Optional[torch.Tensor] = None,
    quantum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Distances from each query to its own gathered candidate rows: [B, C]
    f32, +inf for invalid ids. int8 corpora score SYMMETRICALLY (int8
    query, integer domain) or ASYMMETRICALLY (float query x codes in
    float32; `quantum` maps L2 back to the real domain), as torch ops.

    The float branch (f32 and bf16 arenas) is the graph's hot step. On a
    CUDA tensor it launches the kernel csrc/gather_dist.cu and counts the
    launch in `gathered.launches`; on a CPU tensor it runs
    `gathered_plain`."""
    if vectors.dtype != torch.int8:
        if not vectors.is_cuda:
            return gathered_plain(vectors, ids, queries, metric)
        with tracing.kernel_range("distance.gathered"):
            return _gather_dist(vectors, ids, queries, metric)
    safe = torch.clamp_min(ids, 0).long()
    vecs = vectors[safe]                                   # [B, C, D]
    if queries.dtype == torch.int8:
        dots = (vecs.int() * queries.int()[:, None, :]).sum(-1).float()
        if metric == COSINE:
            cn = torch.clamp_min(corpus_norms[safe], 1e-9)
            qn = torch.clamp_min(query_norms, 1e-9)[:, None]
            d = 1.0 - dots / (qn * cn)
        else:
            q2 = (query_norms ** 2)[:, None]
            c2 = corpus_norms[safe] ** 2
            d = q2 - 2.0 * dots + c2
    else:
        dots = torch.bmm(vecs.float(), queries.float()[:, :, None])[..., 0]
        cn = torch.clamp_min(corpus_norms[safe], 1e-9)     # |x_int|
        if metric == COSINE:
            d = 1.0 - dots / cn          # queries pre-normalized (|q| = 1)
        else:
            # a plain 1.0 copies nothing to the device, which a CUDA
            # graph's capture (the beam's blocks) would refuse
            qm = quantum if quantum is not None else 1.0
            q2 = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
            d = q2 - 2.0 * qm * dots + (qm * cn) ** 2
    return torch.where(ids < 0, INF, d)


def gathered_plain(vectors: torch.Tensor, ids: torch.Tensor,
                   queries: torch.Tensor, metric: str) -> torch.Tensor:
    """Plain PyTorch version of the gather-distance kernel (the float
    branch of `gathered`): L2 = |q|^2 - 2 q.v + |v|^2 with |q|^2 of the
    unrounded query, cosine = 1 - q.v; a bf16 arena's dot takes the query
    rounded to bf16. +inf for ids < 0."""
    safe = torch.clamp_min(ids, 0).long()
    vecs = vectors[safe]                                   # [B, C, D]
    q = queries.to(torch.bfloat16) if vectors.dtype == torch.bfloat16 \
        else queries
    dots = torch.bmm(vecs.float(), q.float()[:, :, None])[..., 0]
    if metric == COSINE:
        d = 1.0 - dots
    else:
        q2 = torch.sum(queries.float() ** 2, dim=-1)[:, None]
        c2 = torch.sum(vecs.float() ** 2, dim=-1)
        d = q2 - 2.0 * dots + c2
    return torch.where(ids < 0, INF, d)


_DTYPE = {torch.float32: 0, torch.bfloat16: 1}      # arena and query
_IDTYPE = {torch.int32: 0, torch.int64: 1}
_METRIC = {L2: 0, COSINE: 1}


def _stream(device: torch.device) -> int:
    """The current CUDA stream of `device`, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def _gather_dist(vectors: torch.Tensor, ids: torch.Tensor,
                 queries: torch.Tensor, metric: str,
                 lib=None) -> torch.Tensor:
    """Launch csrc/gather_dist.cu: [B, C] f32 distances in one launch. Ids
    (int32 or int64) and queries (f32 or bf16) are read in place, so no
    conversion runs beside the kernel; raises on what the kernel does not
    take. Ids at or past the arena's last row score +inf (the plain
    version would raise on them). `lib`: another build of the kernel with
    the same C interface (probes/gather_cold.py); the port's by default."""
    if vectors.dtype not in _DTYPE or vectors.ndim != 2:
        raise TypeError(f"gather_dist takes an f32 or bf16 [N, D] arena, "
                        f"not {vectors.dtype} {tuple(vectors.shape)}")
    if ids.dtype not in _IDTYPE:
        raise TypeError(f"gather_dist takes int32 or int64 ids, not "
                        f"{ids.dtype}")
    if queries.dtype not in _DTYPE:
        raise TypeError(f"gather_dist takes f32 or bf16 queries, not "
                        f"{queries.dtype}")
    if metric not in _METRIC:
        raise ValueError(f"unknown metric {metric!r}")
    B, C = ids.shape
    D = vectors.shape[1]
    if queries.shape != (B, D):
        raise ValueError(f"queries {tuple(queries.shape)} do not match ids "
                         f"{tuple(ids.shape)} and arena width {D}")
    if ids.device != vectors.device or queries.device != vectors.device:
        raise ValueError("gather_dist operands must lie on one device")
    for name, t in (("arena", vectors), ("ids", ids), ("queries", queries)):
        if not t.is_contiguous():
            raise ValueError(f"gather_dist: the {name} must be contiguous")
    out = torch.empty((B, C), dtype=torch.float32, device=ids.device)
    if B * C == 0:
        return out
    err = (lib or native.load()).kektor_gather_dist(
        ids.data_ptr(), _IDTYPE[ids.dtype], queries.data_ptr(),
        _DTYPE[queries.dtype], vectors.data_ptr(), _DTYPE[vectors.dtype],
        out.data_ptr(), B, C, D, vectors.shape[0], _METRIC[metric],
        _stream(vectors.device))
    if err:
        raise RuntimeError(f"gather_dist launch failed: CUDA error {err}")
    gathered.launches += 1
    return out


def gather_route(vectors: torch.Tensor) -> str:
    """The route csrc/gather_dist.cu takes on this arena: row chunks of 16
    or 4 bytes with TM chunks a lane per row (the lanes per row fixed at
    compile time for the common widths), or the scalar route."""
    code = native.load().kektor_gather_dist_route(
        vectors.shape[1], _DTYPE[vectors.dtype], vectors.data_ptr())
    if not code:
        return "scalar"
    lpr, rest = divmod(code, 10000)
    return f"{rest // 100}-byte chunks, TM={rest % 100}" \
        + (f", {lpr} lanes a row fixed" if lpr else "")


gathered.launches = 0


def merge_topk(d: torch.Tensor, i: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest of each row of d, ascending, with their ids. A stable
    sort, so equal distances keep the earlier position first, as
    `jax.lax.top_k` does: the port returns the reference's rows on ties."""
    d, pos = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(i, 1, pos[:, :k])


def brute_force_topk(
    queries: torch.Tensor,       # [B, D]
    corpus: torch.Tensor,        # [N, D]
    k: int,
    metric: str = L2,
    *,
    valid: Optional[torch.Tensor] = None,       # [N] bool: eligible rows
    corpus_norms: Optional[torch.Tensor] = None,
    query_norms: Optional[torch.Tensor] = None,
    block: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by a blocked scan over the corpus with a running merge:
    the recall oracle. Returns (dists [B, k], ids [B, k] int32); masked
    and padded slots have dist = +inf, id = -1. The blocked product is a
    plain matmul, as the reference leaves it to XLA."""
    B, N = queries.shape[0], corpus.shape[0]
    dev = corpus.device
    best_d = torch.full((B, k), INF, device=dev)
    best_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, max(N, 1), block):
        stop = min(start + block, N)
        tn = corpus_norms[start:stop] if corpus_norms is not None else None
        d = pairwise(queries, corpus[start:stop], metric,
                     corpus_norms=tn, query_norms=query_norms)
        if valid is not None:
            d = torch.where(valid[start:stop][None, :], d, INF)
        idx = torch.arange(start, stop, dtype=torch.int32, device=dev)
        best_d, best_i = merge_topk(
            torch.cat([best_d, d], 1),
            torch.cat([best_i, idx[None, :].expand(B, -1)], 1), k)
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i
