"""The comparison that decides `correct`: every answer a run's clients
received, held to the plain reference.

An answer is one query's hits as the client decoded them: rows (the
integer ids the harness gave the rows; -1 where a hit is missing),
distances (NaN where the wire gives none: a text-only hit), scores. The
numbers it gives:

- `unanswered`: requests of the window that never got an answer, or got
  an error or a body that does not decode;
- `bad_answers`: answers with fewer than k hits, a row twice, a row that
  does not exist, or hits out of their order (distances ascending for a
  vector read, scores descending for a hybrid one);
- `dist_err`: the widest gap between a hit's distance and the float64
  distance of its row to its query, over the query's k-th nearest
  distance;
- `recall`: the share of hits that belong to the exact top k, ties at
  the k-th place counted as hits (the ANN-benchmarks rule: within
  `TIE` of the k-th distance, or of the k-th fused score);
- `miss`: 1 - recall;
- `score_err`: the widest gap, over every hit, between a hybrid hit's
  fused score and the reference's for its row (a hit outside the
  reference's candidates counts as a gap of 1).
"""

from __future__ import annotations

import numpy as np
import torch

from . import knn, text

TIE = 1e-6


def _structure(rows: np.ndarray, order_key: np.ndarray, n_rows: int,
               k: int, descending: bool) -> int:
    """Answers that are malformed, by the rules above."""
    want = min(k, n_rows)
    valid = rows >= 0
    bad = valid[:, :want].sum(1) < want
    bad |= ((rows >= n_rows) & valid).any(1)
    srt = np.sort(np.where(valid, rows, -1 - np.arange(k)[None, :]), 1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    key = np.where(valid, order_key, np.nan)[:, :want]
    with np.errstate(invalid="ignore"):
        step = np.diff(key, axis=1)
        wrong = (step > 0) if descending else (step < 0)
        bad |= wrong.any(1) | ~np.isfinite(key).all(1)
    return int(bad.sum())


def _dist_gaps(rows_t, queries_t, pool, hit_rows, hit_dist, metric):
    """float64 distance of every valid hit, and its gap to the wire's."""
    dev = rows_t.device
    valid = hit_rows >= 0
    qi = np.repeat(pool, hit_rows.shape[1])[valid.reshape(-1)]
    ri = hit_rows[valid]
    exact = knn.pair_dist(rows_t, queries_t,
                          torch.from_numpy(qi).to(dev),
                          torch.from_numpy(ri).to(dev), metric).cpu().numpy()
    full = np.full(hit_rows.shape, np.nan)
    full[valid] = exact
    return full, np.abs(full - hit_dist)


def judge_vector(ds, ans: dict, k: int) -> dict:
    metric, rows_t, queries_t = ds["metric"], ds["rows"], ds["queries"]
    pool, hit_rows, hit_dist = ans["pool"], ans["rows"], ans["dist"]
    used = np.unique(pool)
    _, ref_d = knn.to_numpy(*knn.exact_topk(
        rows_t, queries_t[torch.from_numpy(used).to(rows_t.device)], k,
        metric))
    at = np.searchsorted(used, pool)
    kth = ref_d[at, -1]
    exact, gap = _dist_gaps(rows_t, queries_t, pool, hit_rows, hit_dist,
                            metric)
    scale = np.maximum(kth, 1e-12)[:, None]
    with np.errstate(invalid="ignore"):
        rel = np.where(hit_rows >= 0, gap / scale, 0.0)
        hits = (hit_rows >= 0) & (exact <= kth[:, None] * (1 + TIE) + TIE)
    return {"bad_answers": _structure(hit_rows, hit_dist, rows_t.shape[0],
                                      k, descending=False),
            "dist_err": float(np.nanmax(rel)) if rel.size else 0.0,
            "recall": float(hits.sum() / max(hit_rows.size, 1))}


def hybrid_reference(ds, used: np.ndarray, k: int, alpha: float,
                     control: bool = False):
    """(fused scores of every candidate, the vector candidates' rows and
    distances [len(used), FETCH_FACTOR * k]) for each pool query in
    `used`."""
    metric, rows_t = ds["metric"], ds["rows"]
    q = ds["queries"][torch.from_numpy(used).to(rows_t.device)]
    fetch = text.FETCH_FACTOR * k
    top = knn.control_topk if control else knn.exact_topk
    vr, vd = knn.to_numpy(*top(rows_t, q, fetch, metric))
    bm = ds.get("bm25")
    if bm is None:
        bm = ds["bm25"] = text.BM25(ds["vocab"], ds["doc_words"],
                                    ds["doc_offsets"])
    out = []
    for j, p in enumerate(used.tolist()):
        w = ds["query_words"][ds["query_offsets"][p]:
                              ds["query_offsets"][p + 1]]
        tr, tv = bm.scores(w)
        out.append(text.fuse(vr[j], vd[j], tr, tv, alpha, k))
    return out, vr, vd


def judge_hybrid(ds, ans: dict, k: int, alpha: float) -> dict:
    pool, hit_rows = ans["pool"], ans["rows"]
    used = np.unique(pool)
    fused, _, ref_vd = hybrid_reference(ds, used, k, alpha)
    at = np.searchsorted(used, pool)
    ref_kth = np.array([sorted(f.values(), reverse=True)[k - 1]
                        if len(f) >= k else -np.inf for f in fused])
    ref_score = np.full(hit_rows.shape, -np.inf)
    for i, (a, rws) in enumerate(zip(at.tolist(), hit_rows.tolist())):
        f = fused[a]
        for j, r in enumerate(rws):
            if r >= 0:
                ref_score[i, j] = f.get(r, -np.inf)
    valid = hit_rows >= 0
    hits = valid & (ref_score >= ref_kth[at][:, None] - TIE)
    with np.errstate(invalid="ignore"):
        sgap = np.where(np.isfinite(ref_score),
                        np.abs(ans["score"] - ref_score), 1.0)[valid]
    # distances: only the hits that carry one (vector candidates)
    has_d = valid & np.isfinite(ans["dist"])
    d_rows = np.where(has_d, hit_rows, -1)
    _, gap = _dist_gaps(ds["rows"], ds["queries"], pool, d_rows,
                        ans["dist"], ds["metric"])
    scale = np.maximum(ref_vd[at, k - 1], 1e-12)[:, None]
    with np.errstate(invalid="ignore"):
        rel = np.where(has_d, gap / scale, 0.0)
    return {"bad_answers": _structure(hit_rows, ans["score"],
                                      ds["rows"].shape[0], k,
                                      descending=True),
            "dist_err": float(np.nanmax(rel)) if rel.size else 0.0,
            "recall": float(hits.sum() / max(hit_rows.size, 1)),
            "score_err": float(np.max(sgap)) if sgap.size else 0.0}


def judge(ds, ans: dict, mix: dict) -> dict:
    """Every number above for the answers of one run."""
    k = int(mix["k"])
    if mix["read"] == "hybrid":
        out = judge_hybrid(ds, ans, k, float(mix["alpha"]))
    else:
        out = judge_vector(ds, ans, k)
    out["miss"] = 1.0 - out["recall"]
    out["unanswered"] = int(ans["unanswered"])
    return out


def control_answers(ds, pool: np.ndarray, mix: dict) -> dict:
    """The answers the control gives for the queries `pool`: the reference
    in TF32 put in the program's place."""
    k = int(mix["k"])
    used, at = np.unique(pool, return_inverse=True)
    if mix["read"] == "hybrid":
        fused, vr, vd = hybrid_reference(ds, used, k, float(mix["alpha"]),
                                         control=True)
        rows = np.full((used.size, k), -1, np.int64)
        score = np.full((used.size, k), np.nan)
        dist = np.full((used.size, k), np.nan)
        for j, f in enumerate(fused):
            best = sorted(f.items(), key=lambda kv: -kv[1])[:k]
            dmap = dict(zip(vr[j].tolist(), vd[j].tolist()))
            for c, (r, s) in enumerate(best):
                rows[j, c], score[j, c] = r, s
                dist[j, c] = dmap.get(r, np.nan)
    else:
        ids, d = knn.to_numpy(*knn.control_topk(
            ds["rows"], ds["queries"][torch.from_numpy(used).to(
                ds["rows"].device)], k, ds["metric"]))
        rows, dist = ids.astype(np.int64), d
        score = np.full(rows.shape, np.nan)
    return {"pool": pool, "rows": rows[at], "dist": dist[at],
            "score": score[at], "unanswered": 0}
