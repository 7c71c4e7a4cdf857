#!/usr/bin/env python3
"""Smoke test of the PyTorch port (kektordb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, one line each; any failure exits non-zero:
  1 device  the card's name and power limit (nvidia-smi)
  2 build   nvcc builds kektordb_tpu_torch/csrc into build/ (timed)
  3 kernel  pass A (csrc/scan_pass_a.cu) against its plain PyTorch version
            on the card, B=256, N=2^17, D=128, in every precision form,
            and on two arenas whose last tile is ragged (N=2^17+77 and
            2^17+37); then an arena with every row masked (inf, rows -1)
  4 main    the Engine's read path at SIFT-1M width: an hnsw index with
            serve_mode="scan", add_batch of 1,000,000 x 128 SIFT-like f32
            vectors (ids v{i}, seed 1234), 8 searches of 4096 queries,
            k=10; recall@10 against the exact oracle on 1024 queries must
            be >= 0.99 and the hits' distances must agree with the
            oracle's, the pass-A launch count must have grown, and a
            filtered search must return only rows that satisfy the filter
  5 times   pass A at the main path's shape (B=4096, N=2^20, fast form)
            checked against the plain version as in phase 3, then kernel
            and plain timed; ingest seconds, Engine.search QPS at B=4096
  6 gather  gather-distance (csrc/gather_dist.cu) against its plain
            version at the graph's three shapes (build beam B=512 C=256,
            serving beam B=1024 C=128, scan re-rank B=4096 C=32), D=128,
            f32 and bf16 arenas of 2^20 rows, L2 and cosine, 40% of ids
            -1: the same +inf positions and every entry within RTOL of
            |q|^2 + |v|^2 + 2|q||v|; kernel and plain timed
  7 graph   the default index: Engine.create_index with every default
            (serve_mode "auto": the graph is built on insert), add_batch of
            GRAPH_N SIFT-like rows (seed 1234), timed; Engine.search at
            B=4096 from the scan, recall@10 >= 0.99; HNSWIndex.search
            mode="beam" at B=1024, ef_search=100, recall@10 >= 0.95 and
            QPS; then the build's time by part over PARTS_CHUNKS more
            chunks, and the device's busy time under torch.profiler over
            one build chunk and one beam batch, with the operators that
            take most of it
  8 vacuum  20,000 rows: delete 10%, Engine.run_maintenance (vacuum with
            graph healing), beam recall@10 >= 0.95 on the survivors with
            no deleted row returned; Engine.import_batch (fast build +
            full refine) of the same rows into a second index, its beam
            recall@10 >= 0.95
Each path of phases 7 and 8 (the build, the scan search, the beam, vacuum,
import) runs with every launch count set to 0 just before it; its counts
are read and printed just after, and a kernel the path runs must have
launched. Then a JSON line of the kernels, the card's line, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, where torch sees no CUDA device. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_BASE = 1_000_000
DIM = 128
BATCH = 4096
N_BATCHES = 8
K = 10
RECALL_QUERIES = 1024
RECALL_MIN = 0.99
SEED = 1234
KERNEL_B, KERNEL_N = 256, 1 << 17
# rows past KERNEL_N of the two ragged arenas: the GPU tile there is
# ST = 512 rows, W = 64 groups; 77 leaves groups of one or two members,
# 37 leaves 27 groups with no row at all
RAGGED = (77, 37)
HEAD_B, HEAD_N = 4096, 1 << 20
RTOL = 1e-5
DEV = "cuda"
# phase 6: (name, B, C) of the graph's three gathered() shapes
GATHER_SHAPES = (("build beam", 512, 8 * 32), ("serving beam", 1024, 4 * 32),
                 ("scan re-rank", 4096, 32))
GATHER_N = 1 << 20
GATHER_INVALID = 0.4
# phase 7: rows of the default (graph) index, and the beam's batch
GRAPH_N = 1_000_000
BEAM_B, BEAM_BATCHES, BEAM_RECALL_MIN = 1024, 4, 0.95
PARTS_CHUNKS = 8
TOP_OPS = 6
# phase 8
SMALL_N = 20_000


def make_sift_like(n: int, d: int = 128, seed: int = 1234) -> np.ndarray:
    """bench.py's SIFT-like generator: clustered byte-range vectors with
    anisotropic clusters and gamma-tailed magnitudes, clipped to [0, 255]."""
    rng = np.random.default_rng(seed)
    n_clusters = max(4096, n // 64)
    centers = rng.uniform(0.0, 160.0, size=(n_clusters, d)).astype(np.float32)
    scales = rng.uniform(8.0, 14.0, size=(n_clusters, 1)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    bs = 262_144
    for i in range(0, n, bs):
        m = min(bs, n - i)
        which = rng.integers(0, n_clusters, size=m)
        noise = rng.gamma(2.0, 1.0, size=(m, d)).astype(np.float32)
        sign = rng.choice([-1.0, 1.0], size=(m, d)).astype(np.float32)
        out[i:i + m] = np.clip(
            centers[which] + noise * sign * scales[which], 0.0, 255.0)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls, after a warm
    call, between CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def form_cases(torch, quant, dist):
    """(name, q, v, biasA, biasB, fast, exact) for every pass-A form at
    KERNEL_N rows, then two ragged arenas whose last tile is cut short:
    one with groups of one member, one with groups past the last row
    (scores +inf). On the card, from one SIFT-like draw; a tenth of the
    rows masked."""
    from kektordb_tpu_torch.ops import scan
    n_all = KERNEL_N + max(RAGGED)
    X = make_sift_like(n_all + KERNEL_B, DIM, seed=7)
    v32 = torch.from_numpy(X[:n_all]).to(DEV)
    q32 = torch.from_numpy(X[n_all:]).to(DEV)
    live = torch.from_numpy(
        np.random.default_rng(8).random(n_all) > 0.1).to(DEV)
    l2 = scan.serving_bias(v32, (v32 ** 2).sum(-1), live, dist.L2)
    vb, qb = v32.to(torch.bfloat16), q32.to(torch.bfloat16)
    l2b = scan.serving_bias(vb, (vb.float() ** 2).sum(-1), live, dist.L2)
    vn, qn = dist.normalize(v32), dist.normalize(q32)
    qs = quant.train(vn)
    codes, cnorms = quant.quantize(qs, vn)
    qcodes, _ = quant.quantize(qs, qn)
    cos8 = scan.serving_bias(codes, cnorms, live, dist.COSINE)

    def rows(n, v, bias):
        """The first n rows: contiguous prefixes of the arena and biases."""
        return (v[:n], bias[0][:n], bias[1][:n])

    n = KERNEL_N
    r_long, r_short = (KERNEL_N + r for r in RAGGED)
    return [
        ("f32", q32, *rows(n, v32, l2), False, False),
        ("f32_fast", q32, *rows(n, v32, l2), True, False),
        ("bf16", qb, *rows(n, vb, l2b), False, False),
        ("int8", qcodes, *rows(n, codes, cos8), False, False),
        ("asym", qn, *rows(n, codes, cos8), False, True),
        ("asym_fast", qn, *rows(n, codes, cos8), False, False),
        (f"f32_fast N={r_long}", q32, *rows(r_long, v32, l2), True, False),
        (f"int8 N={r_short}", qcodes, *rows(r_short, codes, cos8),
         False, False),
    ]


def exact_scores(torch, scan, q, v, biasA, biasB, form, b, rows):
    """float64 scores of (query b, row) pairs with the form's rounded
    inputs: the referee for argmin disagreements."""
    qq = q[b].double()
    vv = v[rows].double()
    if form in (scan.FORM_F32_FAST, scan.FORM_ASYM_FAST):
        qq = q[b].to(torch.bfloat16).double()
    if form == scan.FORM_F32_FAST:
        vv = v[rows].to(torch.bfloat16).double()
    dots = (qq * vv).sum(-1)
    return biasA[rows].double() - dots * biasB[rows].double()


def compare(torch, name, q, v, bA, bB, st, g, form, kern, plain) -> float:
    """Holds one kernel call's (gmin, garg) against the plain version's on
    the same inputs; raises on a disagreement, prints the case's line and
    returns its max |gmin err|.

    gmin: within RTOL of the largest score term. float32 sums of D
    products in another order differ by at most ~D * 2^-24 of the sum of
    |terms| <= |q| |v|, which RTOL = 1e-5 covers with margin. +inf (masked
    rows, groups past the last row) must match exactly, and there garg too:
    both sides give the last member. garg elsewhere: equal, or the two rows
    score within 2 * tol in float64 on the form's rounded inputs (a tie)."""
    from kektordb_tpu_torch.ops import scan
    (gk, ak), (gp, ap) = kern, plain
    W = st // g
    fin = torch.isfinite(bA)
    scale = float(bA[fin].abs().max()) + float(bB.abs().max()) * float(
        q.float().norm(dim=1).max()) * float(v.float().norm(dim=1).max())
    tol = RTOL * scale
    inf_k, inf_p = torch.isinf(gk), torch.isinf(gp)
    if not torch.equal(inf_k, inf_p):
        raise AssertionError(f"{name}: inf pattern differs")
    if not torch.equal(ak[inf_k], ap[inf_k]):
        raise AssertionError(f"{name}: argmins of +inf groups differ")
    err = float((gk - gp)[~inf_k].abs().max())
    if err > tol:
        raise AssertionError(f"{name}: gmin error {err} > {tol}")
    bad = (ak != ap) & ~inf_k
    nbad = int(bad.sum())
    if nbad:
        b, p = bad.nonzero(as_tuple=True)
        base = (p // W) * st + p % W
        rk = base + ak[b, p].long() * W
        rp = base + ap[b, p].long() * W
        sk = exact_scores(torch, scan, q, v, bA, bB, form, b, rk)
        sp = exact_scores(torch, scan, q, v, bA, bB, form, b, rp)
        gap = float((sk - sp).abs().max())
        if gap > 2 * tol:
            raise AssertionError(
                f"{name}: {nbad} argmins differ by {gap} > {2 * tol}")
    print(f"phase kernel {name}: B={q.shape[0]} N={v.shape[0]} ST={st} "
          f"G={g} form {form}, max|gmin err| {err:.6g} (tol {tol:.6g}), "
          f"+inf groups {int(inf_k.sum())}, argmin ties differing {nbad}",
          flush=True)
    return err


def check_kernels(torch) -> float:
    """Phase 3. Returns the largest |gmin kernel - gmin plain| seen."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import quantize as quant
    from kektordb_tpu_torch.ops import scan
    worst = 0.0
    for name, q, v, bA, bB, fast, exact in form_cases(torch, quant, dist):
        st, g = scan.kernel_tiles(v.shape[0])
        form = scan.pass_a_form(q.dtype, v.dtype, fast=fast, exact=exact)
        kern = scan.pass_a(q, v, bA, bB, st=st, g=g, fast=fast, exact=exact)
        torch.cuda.synchronize()
        plain = scan.pass_a_plain(q, v, bA, bB, st=st, g=g, form=form)
        worst = max(worst, compare(torch, name, q, v, bA, bB, st, g, form,
                                   kern, plain))
    # every row masked: inf scores, rows -1
    q = torch.ones((KERNEL_B, DIM), device=DEV)
    v = torch.zeros((KERNEL_N, DIM), device=DEV)
    bA = torch.full((KERNEL_N,), float("inf"), device=DEV)
    bB = torch.full((KERNEL_N,), 2.0, device=DEV)
    d, rows = scan._scan_kernel(q, v, bA, bB, K)
    if not (torch.isinf(d).all() and (rows == -1).all()):
        raise AssertionError("all-masked arena: expected inf and -1")
    print("phase kernel masked: all scores inf, all rows -1", flush=True)
    return worst


def check_distances(hits, got, gt_d, gt, queries, base) -> float:
    """The Engine's distances against the exact oracle's for every hit
    both return. Both are squared L2 in float32 from the same f32 inputs,
    summed in another order: they agree within RTOL of the sum of the
    terms' magnitudes, |q|^2 + |x|^2 + 2|q||x|. Each query's distances must
    also ascend. Returns the largest |err|."""
    worst = 0.0
    for b, h in enumerate(hits):
        d = np.array([x["distance"] for x in h])
        if np.any(np.diff(d) < 0):
            raise AssertionError(f"query {b}: distances do not ascend")
        oracle = dict(zip(gt[b].tolist(), gt_d[b].tolist()))
        q2 = float(np.dot(queries[b], queries[b]))
        for row, dd in zip(got[b].tolist(), d.tolist()):
            if row not in oracle:
                continue
            x2 = float(np.dot(base[row], base[row]))
            tol = RTOL * (q2 + x2 + 2.0 * np.sqrt(q2 * x2))
            err = abs(dd - oracle[row])
            if err > tol:
                raise AssertionError(
                    f"query {b} row {row}: distance {dd} against the "
                    f"oracle's {oracle[row]}, |err| {err} > {tol}")
            worst = max(worst, err)
    return worst


def recall_at(got: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(got[b]) & set(gt[b])) / K
                          for b in range(gt.shape[0])]))


def main_path(torch, card: str) -> dict:
    """Phase 4 and the end-to-end times of phase 5."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    X = make_sift_like(N_BASE + N_BATCHES * BATCH, DIM, seed=SEED)
    base, queries = X[:N_BASE], X[N_BASE:]
    ids = [f"v{i}" for i in range(N_BASE)]
    metas = [{"cat": "a" if i % 100 == 0 else "b"} for i in range(N_BASE)]

    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("sift", metric=dist.L2, kind="hnsw", serve_mode="scan")
    scan.pass_a.launches = 0
    dist.gathered.launches = 0
    t0 = time.perf_counter()
    eng.add_batch("sift", ids, base, metas)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    eng.search("sift", queries[:BATCH], k=K)             # warm
    t0 = time.perf_counter()
    results = [eng.search("sift", queries[i * BATCH:(i + 1) * BATCH], k=K)
               for i in range(N_BATCHES)]
    search_s = time.perf_counter() - t0
    filtered = eng.search("sift", queries[:64], k=K, filter="cat = 'a'")
    launches = scan.pass_a.launches
    rerank = dist.gathered.launches
    print(f"phase main: ingest {N_BASE} x {DIM} in {ingest_s:.3f} s; "
          f"{N_BATCHES} x {BATCH} queries in {search_s:.3f} s; "
          f"pass-A launches {launches}, gather-distance launches (re-rank) "
          f"{rerank} [{card}]", flush=True)
    if launches < N_BATCHES:
        raise AssertionError(f"pass A launched {launches} times")
    if rerank < N_BATCHES:
        raise AssertionError(f"the re-rank launched gather_dist {rerank} "
                             "times")

    for res in results:
        if len(res) != BATCH or any(len(h) != K for h in res):
            raise AssertionError("search returned a wrong shape")
        if not all(np.isfinite(x["distance"]) for h in res for x in h):
            raise AssertionError("search returned a non-finite distance")
    got = np.array([[int(x["id"][1:]) for x in h]
                    for h in results[0][:RECALL_QUERIES]])
    base_t = torch.from_numpy(base).to(DEV)
    gt_d, gt = dist.brute_force_topk(
        torch.from_numpy(queries[:RECALL_QUERIES]).to(DEV), base_t, K)
    gt_d, gt = gt_d.cpu().numpy(), gt.cpu().numpy()
    recall = recall_at(got, gt)
    print(f"phase main: recall@{K} {recall:.4f} on {RECALL_QUERIES} "
          f"queries (exact oracle), min {RECALL_MIN}", flush=True)
    if recall < RECALL_MIN:
        raise AssertionError(f"recall {recall} < {RECALL_MIN}")
    d_err = check_distances(results[0][:RECALL_QUERIES], got, gt_d, gt,
                            queries[:RECALL_QUERIES], base)
    print(f"phase main: squared L2 distances of the hits the oracle also "
          f"returns, max |err| {d_err:.6g} against the oracle's, within "
          f"{RTOL} of |q|^2 + |x|^2 + 2|q||x|; ascending per query",
          flush=True)
    hits = [x["id"] for h in filtered for x in h]
    if not hits or any(int(e[1:]) % 100 for e in hits):
        raise AssertionError("filtered search broke its filter")
    print(f"phase main: filtered search, {len(hits)} hits, all cat = 'a'",
          flush=True)
    return {"ingest_s": ingest_s, "qps": N_BATCHES * BATCH / search_s,
            "recall": recall, "launches": launches}


def time_pass_a(torch, card: str) -> tuple[float, float, float]:
    """Phase 5: pass A (fast form, the serving read's candidate pass) at
    the main path's shape, B=4096, N=2^20 (ST=1024, G=16): one kernel
    call held against one plain call as in phase 3, then both timed in
    turns on one card. Returns (kernel ms, plain ms, max |gmin err|)."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    X = make_sift_like(HEAD_N + HEAD_B, DIM, seed=11)
    v = torch.from_numpy(X[:HEAD_N]).to(DEV)
    q = torch.from_numpy(X[HEAD_N:]).to(DEV)
    bA, bB = scan.serving_bias(v, (v ** 2).sum(-1),
                               torch.ones(HEAD_N, dtype=torch.bool,
                                          device=DEV), dist.L2)
    st, g = scan.kernel_tiles(HEAD_N)
    form = scan.pass_a_form(q.dtype, v.dtype, fast=True)
    kern = scan.pass_a(q, v, bA, bB, st=st, g=g, fast=True)
    torch.cuda.synchronize()
    plain = scan.pass_a_plain(q, v, bA, bB, st=st, g=g, form=form)
    err = compare(torch, "f32_fast, main path's shape", q, v, bA, bB, st, g,
                  form, kern, plain)
    del kern, plain

    def kernel():
        scan.pass_a(q, v, bA, bB, st=st, g=g, fast=True)

    def plain():
        scan.pass_a_plain(q, v, bA, bB, st=st, g=g, form=form)

    ks, ps = [], []
    for _ in range(2):
        ks.append(cuda_ms(torch, kernel, 5))
        ps.append(cuda_ms(torch, plain, 3))
    kms, pms = sum(ks) / 2, sum(ps) / 2
    print(f"phase times: pass A B={HEAD_B} N={HEAD_N} D={DIM} fast form: "
          f"kernel {kms:.3f} ms, plain {pms:.3f} ms [{card}]", flush=True)
    return kms, pms, err


def check_gather(torch, card) -> dict:
    """Phase 6. Returns {"max_abs_err", "ms", "plain_ms" (the build
    beam's f32 L2 case, the graph's hottest call), "by_shape"}."""
    from kektordb_tpu_torch.ops import distance as dist
    X = make_sift_like(GATHER_N + 4096, DIM, seed=13)
    v32 = torch.from_numpy(X[:GATHER_N]).to(DEV)
    q32 = torch.from_numpy(X[GATHER_N:]).to(DEV)
    arenas = {
        ("f32", dist.L2): (v32, q32),
        ("bf16", dist.L2): (v32.to(torch.bfloat16), q32.to(torch.bfloat16)),
        ("f32", dist.COSINE): (dist.normalize(v32), dist.normalize(q32)),
        ("bf16", dist.COSINE): (dist.normalize(v32).to(torch.bfloat16),
                                dist.normalize(q32)),
    }
    rng = np.random.default_rng(14)
    worst, times = 0.0, {}
    for shape, B, C in GATHER_SHAPES:
        ids_np = rng.integers(0, GATHER_N, size=(B, C)).astype(np.int32)
        ids_np[rng.random((B, C)) < GATHER_INVALID] = -1
        ids = torch.from_numpy(ids_np).to(DEV)
        for (dt, metric), (v, qa) in arenas.items():
            q = qa[:B]
            got = dist.gathered(v, ids, q, metric)
            torch.cuda.synchronize()
            want = dist.gathered_plain(v, ids, q, metric)
            inf_k, inf_p = torch.isinf(got), torch.isinf(want)
            if not torch.equal(inf_k, inf_p) \
                    or not torch.equal(inf_k, ids < 0):
                raise AssertionError(f"gather {shape} {dt} {metric}: "
                                     "+inf positions differ")
            qn = q.float().norm(dim=1)[:, None]
            vn = v.float().norm(dim=1)[ids.clamp_min(0).long()]
            tol = RTOL * (qn + vn) ** 2
            err = (got - want).abs()[~inf_k]
            ratio = float((err / tol[~inf_k]).max())
            if ratio > 1.0:
                raise AssertionError(f"gather {shape} {dt} {metric}: error "
                                     f"{float(err.max())} past tolerance "
                                     f"(x{ratio:.3g})")
            worst = max(worst, float(err.max()))

            def kernel():
                dist.gathered(v, ids, q, metric)

            def plain():
                dist.gathered_plain(v, ids, q, metric)
            kms = cuda_ms(torch, kernel, 20)
            pms = cuda_ms(torch, plain, 5)
            times[f"{shape} {dt} {metric}"] = (kms, pms)
            print(f"phase gather {shape} B={B} C={C} {dt} {metric}: max|err| "
                  f"{float(err.max()):.6g} ({ratio:.3g} of tol), +inf "
                  f"{int(inf_k.sum())}; kernel {kms:.4f} ms, plain "
                  f"{pms:.4f} ms [{card}]", flush=True)
    kms, pms = times[f"{GATHER_SHAPES[0][0]} f32 {dist.L2}"]
    return {"max_abs_err": worst, "ms": kms, "plain_ms": pms,
            "by_shape": times}


def counted(torch, path: str, fn, need: tuple[str, ...]):
    """Runs one path with every launch count set to 0 just before it and
    reads the counts just after; every kernel in `need` must have launched.
    Returns (fn's result, seconds, counts)."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    dist.gathered.launches = 0
    scan.pass_a.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = {"gather_dist": dist.gathered.launches,
              "scan_pass_a": scan.pass_a.launches}
    print(f"phase launches, {path}: gather_dist {counts['gather_dist']}, "
          f"scan_pass_a {counts['scan_pass_a']}", flush=True)
    missing = [k for k in need if counts[k] < 1]
    if missing:
        raise AssertionError(f"{path}: {missing} never launched")
    return out, sec, counts


def device_ms(torch, fn) -> tuple[float, float, str]:
    """(device ms, wall ms, top ops) of one call under torch.profiler: the
    device time is the sum of the CUDA kernels' own times, NaN where the
    profiler recorded none; top ops names the TOP_OPS operators with the
    most device time, each with its share of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == cuda) / 1e3
    if dev <= 0:
        return float("nan"), wall, "none recorded"
    # aten operators own the kernels they launch; the port's own kernels
    # launch through ctypes, outside any operator, so they are read from
    # the kernel events by name
    ops: dict[str, float] = {}
    for e in events:
        if e.device_type != cuda and e.key.startswith("aten::"):
            name = e.key
        elif e.device_type == cuda and "gather_dist_kernel" in e.key:
            name = "gather_dist"
        elif e.device_type == cuda and "pass_a_kernel" in e.key:
            name = "scan_pass_a"
        else:
            continue
        ops[name] = ops.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return dev, wall, ", ".join(f"{k} {ms / dev:.1%}" for k, ms in top)


def build_parts(torch, idx, card: str) -> None:
    """Phase 7's breakdown on the built index: PARTS_CHUNKS more chunks
    through the steps of hnsw_kernels.insert_chunk and _register_upper,
    one at a time with a synchronize after each (host clock; the syncs add
    a little); then one chunk through HNSWIndex._commit under the
    profiler, whose device time against the unprofiled chunk gives the
    device's idle share during the build."""
    from kektordb_tpu_torch.index import hnsw_kernels as K
    cfg, ch = idx.config, idx.config.chunk
    X = make_sift_like((PARTS_CHUNKS + 1) * ch, DIM, seed=SEED + 2)
    parts: dict[str, float] = {}
    for c in range(PARTS_CHUNKS):
        blk = X[c * ch:(c + 1) * ch]
        torch.cuda.synchronize()
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            parts[name] = parts.get(name, 0.0) + (now - t) * 1e3 / PARTS_CHUNKS
            t = now
        idx._grow_for(ch)
        rows = np.fromiter((idx.ids.alloc(f"p{c}_{i}") for i in range(ch)),
                           np.int32, ch)
        levels = idx._sample_levels(ch)
        enc, norms = idx._encode(blk)
        tr, tl = idx._rows(rows), idx._rows(levels)
        K.write_vectors(idx.state, tr, enc, norms)
        lap("encode, upload, arena write")
        bd, bi = K.beam_search(idx.state, enc, norms, metric=idx.metric,
                               ef=cfg.ef_construction,
                               dual=bool(idx._deleted_rows),
                               expand=cfg.expand)
        lap("beam_search")
        all_d, all_i = K._with_intra(bd, bi, enc, norms, tr, idx.metric,
                                     cfg.intra_k)
        lap("intra-chunk top-k")
        sel_i, sel_d = K.select_neighbors(idx.state, all_d, all_i, cfg.m,
                                          idx.metric)
        lap("select_neighbors")
        K.commit_chunk(idx.state, tr, sel_i, sel_d, tl, metric=idx.metric,
                       m=cfg.m)
        lap("commit_chunk")
        idx._register_upper([(int(r), int(lv)) for r, lv in
                             zip(rows, levels) if lv >= 1])
        lap("update_upper")
    chunk_ms = sum(parts.values())
    for name, ms in parts.items():
        print(f"phase graph parts: {name} {ms:.3f} ms of a {ch}-row chunk "
              f"({ms / chunk_ms:.1%}), mean of {PARTS_CHUNKS} chunks "
              f"[{card}]", flush=True)
    dev, wall, top = device_ms(torch, lambda: idx._commit(
        [f"p{PARTS_CHUNKS}_{i}" for i in range(ch)], X[PARTS_CHUNKS * ch:],
        cfg.ef_construction))
    print(f"phase graph parts: one chunk under the profiler: device "
          f"{dev:.3f} ms in {wall:.3f} ms wall (idle {1 - dev / wall:.3f}); "
          f"against the unprofiled {chunk_ms:.3f} ms chunk, idle "
          f"{1 - dev / chunk_ms:.3f}; device time by op: {top} [{card}]",
          flush=True)


def graph_path(torch, card: str) -> dict:
    """Phase 7: the default index (serve_mode "auto") built and served."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    X = make_sift_like(GRAPH_N + BATCH, DIM, seed=SEED)
    base, queries = X[:GRAPH_N], X[GRAPH_N:]
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("graph")                      # every default
    ids = [f"g{i}" for i in range(GRAPH_N)]
    _, build_s, _ = counted(torch, "graph build (Engine.add_batch)",
                            lambda: eng.add_batch("graph", ids, base),
                            ("gather_dist",))
    idx = eng.indexes["graph"].index
    res, _, _ = counted(torch, "Engine.search (scan)",
                        lambda: eng.search("graph", queries, k=K),
                        ("scan_pass_a", "gather_dist"))
    idx.search(queries[:BEAM_B], K, mode="beam")   # warm

    def beam():
        return [idx.search(queries[i * BEAM_B:(i + 1) * BEAM_B], K,
                           mode="beam") for i in range(BEAM_BATCHES)]
    beams, beam_s, beam_counts = counted(
        torch, "HNSWIndex.search mode='beam'", beam, ("gather_dist",))
    for d, r in beams:
        if not np.isfinite(d).all() or d.shape != (BEAM_B, K):
            raise AssertionError("beam returned a wrong shape or non-finite "
                                 "distance")

    gt = dist.brute_force_topk(
        torch.from_numpy(queries[:RECALL_QUERIES]).to(DEV),
        torch.from_numpy(base).to(DEV), K)[1].cpu().numpy()
    if len(res) != BATCH or any(len(h) != K for h in res):
        raise AssertionError("graph index: search returned a wrong shape")
    scan_got = np.array([[int(x["id"][1:]) for x in h]
                         for h in res[:RECALL_QUERIES]])
    scan_recall = recall_at(scan_got, gt)
    beam_recall = recall_at(beams[0][1][:RECALL_QUERIES], gt)
    nb = idx.state.nbrs[:GRAPH_N]
    deg = int((nb >= 0).sum(1).max())
    self_links = bool((nb == torch.arange(GRAPH_N, device=DEV)[:, None])
                      .any())
    print(f"phase graph: Engine.create_index defaults (serve_mode "
          f"{idx.config.serve_mode!r}, m={idx.config.m}, ef_construction="
          f"{idx.config.ef_construction}, ef_search={idx.config.ef_search}); "
          f"add_batch {GRAPH_N} x {DIM} built in {build_s:.3f} s; max level "
          f"{int(idx.state.max_level)}, max degree {deg}, self-links "
          f"{self_links} [{card}]", flush=True)
    print(f"phase graph: Engine.search B={BATCH} (scan) recall@{K} "
          f"{scan_recall:.4f}; HNSWIndex.search mode='beam' B={BEAM_B} "
          f"ef_search={idx.config.ef_search}: recall@{K} {beam_recall:.4f}, "
          f"{BEAM_BATCHES * BEAM_B / beam_s:.1f} QPS [{card}]", flush=True)
    if scan_recall < RECALL_MIN:
        raise AssertionError(f"scan recall {scan_recall} < {RECALL_MIN}")
    if beam_recall < BEAM_RECALL_MIN:
        raise AssertionError(f"beam recall {beam_recall} < "
                             f"{BEAM_RECALL_MIN}")
    if deg > 2 * idx.config.m or self_links:
        raise AssertionError("graph invariants broken (degree, self-links)")
    dev, wall, top = device_ms(torch, lambda: idx.search(
        queries[:BEAM_B], K, mode="beam"))
    beam_ms = beam_s * 1e3 / BEAM_BATCHES
    print(f"phase graph: one beam batch under the profiler: device "
          f"{dev:.3f} ms in {wall:.3f} ms wall; against the unprofiled "
          f"{beam_ms:.3f} ms batch, idle {1 - dev / beam_ms:.3f}; device "
          f"time by op: {top} [{card}]", flush=True)
    build_parts(torch, idx, card)
    eng.close()
    return {"build_s": build_s, "beam_qps": BEAM_BATCHES * BEAM_B / beam_s,
            "beam_recall": beam_recall, "scan_recall": scan_recall,
            "beam_launches": beam_counts["gather_dist"]}


def vacuum_and_import(torch, card: str) -> None:
    """Phase 8: delete 10%, vacuum with healing, beam on the survivors;
    import_batch into a second index."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    X = make_sift_like(SMALL_N + BEAM_B, DIM, seed=SEED + 1)
    base, queries = X[:SMALL_N], X[SMALL_N:]
    ids = [f"s{i}" for i in range(SMALL_N)]
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("small")
    eng.add_batch("small", ids, base)
    dead = np.arange(0, SMALL_N, 10)
    for i in dead:
        eng.delete("small", f"s{i}")
    cycles, vac_s, _ = counted(torch, "vacuum (Engine.run_maintenance)",
                               eng.run_maintenance, ("gather_dist",))
    cycle = cycles["small"]
    idx = eng.indexes["small"].index
    if cycle != "vacuum" or idx.deleted_count:
        raise AssertionError(f"maintenance ran {cycle!r}, "
                             f"{idx.deleted_count} rows still deleted")
    alive = np.ones(SMALL_N, bool)
    alive[dead] = False
    base_t = torch.from_numpy(base).to(DEV)
    q_t = torch.from_numpy(queries).to(DEV)
    gt = dist.brute_force_topk(q_t, base_t, K, valid=torch.from_numpy(
        alive).to(DEV))[1].cpu().numpy()
    (_, rows), _, _ = counted(
        torch, "beam on the survivors",
        lambda: idx.search(queries, K, mode="beam"), ("gather_dist",))
    if np.isin(rows, dead).any():
        raise AssertionError("beam returned a vacuumed row")
    rec_vac = recall_at(rows, gt)

    eng.create_index("imported")
    _, imp_s, _ = counted(torch, "Engine.import_batch",
                          lambda: eng.import_batch("imported", ids, base),
                          ("gather_dist",))
    imp = eng.indexes["imported"].index
    gt_all = dist.brute_force_topk(q_t, base_t, K)[1].cpu().numpy()
    (_, rows), _, _ = counted(
        torch, "beam on the imported index",
        lambda: imp.search(queries, K, mode="beam"), ("gather_dist",))
    rec_imp = recall_at(rows, gt_all)
    print(f"phase vacuum: {SMALL_N} rows, {dead.size} deleted, maintenance "
          f"{cycle!r} in {vac_s:.3f} s, beam recall@{K} on the survivors "
          f"{rec_vac:.4f}; import_batch (fast build + refine) in "
          f"{imp_s:.3f} s, beam recall@{K} {rec_imp:.4f}, needs_refine "
          f"{imp.needs_refine} [{card}]", flush=True)
    if min(rec_vac, rec_imp) < BEAM_RECALL_MIN or imp.needs_refine:
        raise AssertionError("vacuum / import beam recall below "
                             f"{BEAM_RECALL_MIN}")
    eng.close()


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"phase device: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from kektordb_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text(
        ).splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase build: {lib.name} in {build_s:.3f} s", flush=True)
    for ln in ptxas:
        print(f"phase build: {ln}", flush=True)

    max_err = check_kernels(torch)
    main = main_path(torch, card)
    kms, pms, head_err = time_pass_a(torch, card)
    max_err = max(max_err, head_err)
    print(f"phase times: ingest {main['ingest_s']:.3f} s, Engine.search "
          f"{main['qps']:.1f} QPS at B={BATCH}, recall@{K} "
          f"{main['recall']:.4f} [{card}]", flush=True)
    gather = check_gather(torch, card)
    graph = graph_path(torch, card)
    vacuum_and_import(torch, card)

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "kektordb_tpu.ops",
                                             "kektordb_tpu.index",
                                             "kektordb_tpu.engine"))]
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")
    print(f"phase total: {time.perf_counter() - t_start:.1f} s [{card}]",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "scan_pass_a", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/scan_pass_a.cu",
        "replaces": "kektordb_tpu/ops/scan.py:175",
        "launches": main["launches"], "max_abs_err": max_err,
        "ms": kms, "plain_ms": pms}, {
        "name": "gather_dist", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/gather_dist.cu",
        "replaces": "scripts/pallas_gather.py:120, "
                    "scripts/pallas_gather2.py:170",
        "launches": graph["beam_launches"],
        "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
        "plain_ms": gather["plain_ms"],
        "ms_by_case": {k: v[0] for k, v in gather["by_shape"].items()},
        "plain_ms_by_case": {k: v[1] for k, v in
                             gather["by_shape"].items()}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
