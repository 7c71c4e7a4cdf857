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
Then a JSON line of the kernels, the card's line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, where
torch sees no CUDA device. Imports no JAX.
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
    print(f"phase main: ingest {N_BASE} x {DIM} in {ingest_s:.3f} s; "
          f"{N_BATCHES} x {BATCH} queries in {search_s:.3f} s; "
          f"pass-A launches {launches} [{card}]", flush=True)
    if launches < N_BATCHES:
        raise AssertionError(f"pass A launched {launches} times")

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
    recall = float(np.mean([len(set(got[b]) & set(gt[b])) / K
                            for b in range(RECALL_QUERIES)]))
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


def main() -> int:
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

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "kektordb_tpu.ops",
                                             "kektordb_tpu.index",
                                             "kektordb_tpu.engine"))]
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")
    print(json.dumps({"kernels": [{
        "name": "scan_pass_a", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/scan_pass_a.cu",
        "replaces": "kektordb_tpu/ops/scan.py:175",
        "launches": main["launches"], "max_abs_err": max_err,
        "ms": kms, "plain_ms": pms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
