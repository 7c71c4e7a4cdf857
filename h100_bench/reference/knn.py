"""Plain exact nearest neighbours, the reference for a vector read.

Distances as the program defines them: squared euclidean for
"euclidean", 1 - cos for "cosine". Candidates are picked by a float32
product with TF32 off, more than asked for, and then ranked by the
distance computed again in float64 from the rows themselves, so the
reference's order is exact wherever the float32 pick holds the true
neighbours (it holds them by a wide margin: `CANDIDATES` against k).

`control_topk` is the same search in the precision just below the one
the configurations state (TF32 for float32), with no float64 re-rank: it
stands in the program's place to show that the comparison fails it.
"""

from __future__ import annotations

import numpy as np
import torch

CANDIDATES = 64
BLOCK = 1024


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits, round to nearest even) as
    float32: the inputs a TF32 product takes, for a device that has no
    TF32 (the CPU)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _expanded(q: torch.Tensor, rows: torch.Tensor, metric: str,
              row_sq: torch.Tensor | None) -> torch.Tensor:
    dots = q @ rows.T
    if metric == "cosine":
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        rn = torch.linalg.vector_norm(rows, dim=1)
        return 1.0 - dots / (qn * rn[None, :]).clamp_min(1e-30)
    return (q * q).sum(1, keepdim=True) - 2.0 * dots + row_sq[None, :]


def pair_dist(rows: torch.Tensor, queries: torch.Tensor, qi: torch.Tensor,
              ri: torch.Tensor, metric: str) -> torch.Tensor:
    """Exact float64 distance of each pair (queries[qi], rows[ri])."""
    out = torch.empty(qi.shape[0], dtype=torch.float64, device=rows.device)
    step = 1 << 18
    for s in range(0, qi.shape[0], step):
        q = queries[qi[s:s + step]].double()
        x = rows[ri[s:s + step]].double()
        if metric == "cosine":
            c = (q * x).sum(1) / (torch.linalg.vector_norm(q, dim=1)
                                  * torch.linalg.vector_norm(x, dim=1)
                                  ).clamp_min(1e-300)
            out[s:s + step] = 1.0 - c
        else:
            out[s:s + step] = ((q - x) ** 2).sum(1)
    return out


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int,
               metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [Q, k] int64, distances [Q, k] float64), nearest first, ties
    by the lower row."""
    _no_tf32()
    n = rows.shape[0]
    c = min(max(CANDIDATES, 4 * k), n)
    row_sq = (rows.double() ** 2).sum(1).float() if metric != "cosine" \
        else None
    ids = torch.empty(queries.shape[0], k, dtype=torch.int64,
                      device=rows.device)
    ds = torch.empty(queries.shape[0], k, dtype=torch.float64,
                     device=rows.device)
    for s in range(0, queries.shape[0], BLOCK):
        q = queries[s:s + BLOCK].float()
        d32 = _expanded(q, rows.float(), metric, row_sq)
        cand = torch.topk(d32, c, dim=1, largest=False).indices
        b = q.shape[0]
        qi = torch.arange(s, s + b, device=rows.device).repeat_interleave(c)
        d64 = pair_dist(rows, queries, qi, cand.reshape(-1),
                        metric).reshape(b, c)
        # ties by the lower row: sort by row, then stably by distance
        by_row = torch.sort(cand, dim=1).indices
        cand = torch.gather(cand, 1, by_row)
        d64 = torch.gather(d64, 1, by_row)
        order = torch.sort(d64, dim=1, stable=True).indices[:, :k]
        ids[s:s + b] = torch.gather(cand, 1, order)
        ds[s:s + b] = torch.gather(d64, 1, order)
    return ids, ds


def control_topk(rows: torch.Tensor, queries: torch.Tensor, k: int,
                 metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest by a TF32 product, with its TF32 distances."""
    cuda = rows.is_cuda
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = rows.float() if cuda else _tf32_round(rows.float())
        row_sq = (rows.float() ** 2).sum(1) if metric != "cosine" else None
        ids, ds = [], []
        for s in range(0, queries.shape[0], BLOCK):
            q = queries[s:s + BLOCK].float()
            q = q if cuda else _tf32_round(q)
            d = _expanded(q, x, metric, row_sq)
            top = torch.topk(d, k, dim=1, largest=False)
            ids.append(top.indices)
            ds.append(top.values.double())
    finally:
        _no_tf32()
    return torch.cat(ids), torch.cat(ds)


def to_numpy(*ts: torch.Tensor) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in ts]
