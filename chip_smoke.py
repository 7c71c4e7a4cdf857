#!/usr/bin/env python3
"""Smoke test of the PyTorch port (kektordb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, one line each; any failure exits non-zero:
  1 device  the card's name and power limit (nvidia-smi)
  2 build   nvcc builds kektordb_tpu_torch/csrc into build/, one compiler
            per source at once, then one link (timed)
  3 kernel  pass A against its plain PyTorch version on the card, B=256,
            N=2^17, D=128, in every precision form (forms 1, 2, 5 on the
            tensor-core kernel csrc/scan_pass_a_wgmma.cu, 0, 3, 4 on the
            CUDA-core kernel csrc/scan_pass_a.cu; each line names its
            kernel), and on two arenas whose last tile is ragged
            (N=2^17+77 and 2^17+37); then the tensor-core kernel's edges:
            B=200 (a last query slab cut short), D=100 (a depth tail),
            D=768 (a query slab streamed with each depth chunk) and a bf16
            arena at D=100 (200-byte rows, a stride no 16-byte copy
            takes); then an arena with every row masked (inf, rows -1)
  4 main    the Engine's read path at SIFT-1M width: an hnsw index with
            serve_mode="scan", add_batch of 1,000,000 x 128 SIFT-like f32
            vectors (ids v{i}, seed 1234), 8 searches of 4096 queries,
            k=10; recall@10 against the exact oracle on 1024 queries must
            be >= 0.99 and the hits' distances must agree with the
            oracle's, the pass-A launch count must have grown, and a
            filtered search must return only rows that satisfy the
            filter; one search under the profiler (device time by op)
  5 times   pass A at the main path's shape (B=4096, N=2^20, fast form)
            checked against the plain version as in phase 3, then kernel,
            plain and torch.matmul of the product alone timed; ingest
            seconds, Engine.search QPS at B=4096
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
  9 probes  the probe entry points, kektordb_tpu_torch.probes.matmul_ceiling
            (the three torch.matmul ceilings and scan_vT, csrc/scan_pass_a.cu
            over a transposed bf16 arena) and .scan_proto (scan_reduce, pass
            A's bf16 form, at the 7 (BT, ST, G) of the script's sweep, and
            its float64 check), at B=4096, N=2^20, D=128; then scan_vT at
            (ST, G) = (4096, 8) and scan_reduce at each of the 7 tuples held
            against their plain versions as in phase 3, both also on an
            arena of N=2^20+77 rows; kernel and plain timed
 10 hybrid  the default index with HYBRID_N SIFT-like rows (seed 1236), each
            with 8-16 words of a seeded 5,000-word Zipf vocabulary indexed
            as text and a _created_at over the past 30 days; Engine.search
            at B=1024, k=10, text_query, alpha 0, 0.5 and 1: the device
            epilogue (ops/fuse.fused_topk) must run, and its hits agree with
            the host path (Engine._assemble_fused) on the same scan output
            (scores within FUSE_TOL, ids equal wherever adjacent fused
            scores differ by more); QPS; recall@10 of alpha 1 against the
            exact oracle >= 0.99; pass A and gather-distance at this
            search's shapes (B=1024 over the index's own 2^19-row arena;
            the re-rank's 32 candidates) held against their plain versions
            as in phases 3 and 6; one search under the profiler
 11 decay   the same engine: configure_index(memory: decay_half_life 1 day,
            an "episodic" layer); a decayed search at B=1024 (mirror built),
            then REINFORCE_ROUNDS times: reinforce of 64 queries' top hits
            and the search again (mirror refreshed in place:
            update_decay_device, no rebuild); each against the host path
            as in phase 10; QPS of each and of STEADY more; one under the
            profiler
Kernel times are the card's own: the timed calls queue behind a sleep
kernel so the host is ahead (kektordb_tpu_torch.probes.timed), and the
host's issue time per call is printed beside each. Each path of phases
7 to 11 (the build, the scan search, the beam, vacuum,
import, the two probes, the hybrid and decayed searches) runs with every
launch count set to 0 just before it; its counts are read and printed just
after, and a kernel the path runs must have launched. Then a JSON line of
the kernels (each with its bound: the larger of its bytes over the HBM
rate and its operations over the peak rate of their type), the card's
line, and as the last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, where torch sees no CUDA device. Imports nothing of
JAX or of the JAX package.
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
# phase 3's edges of the tensor-core kernel: (label, B, D, arena dtype)
EDGE_CASES = (("B=200", 200, DIM, "f32"),
              ("depth tail", KERNEL_B, 100, "f32"),
              ("streamed query slab", KERNEL_B, 768, "f32"),
              ("200-byte rows", KERNEL_B, 100, "bf16"))
MATMUL_CHUNK = 1 << 17   # rows per torch.matmul of the product yardstick
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
# phase 9: the probes' shape, the transposed probe's tile, the ragged arena
PROBE_B, PROBE_N = 4096, 1 << 20
VT_TILE = (4096, 8)
PROBE_RAGGED = 77
# phases 10-11
HYBRID_N, HYBRID_B, HYBRID_SEED = 500_000, 1024, 1236
STEADY = 3           # decayed searches timed once the mirror is fresh
REINFORCE_ROUNDS = 2
VOCAB, WORDS = 5000, (8, 16)
TEXT_QUERY = "t40 t300 t1200"
DAY = 86400.0
REINFORCED = 64
FUSE_TOL = 1e-5
RERANK_C = 32        # the scan re-rank's candidates (kf) at k = 2 * K
# the bound: NVIDIA's H100 SXM figures (dense), at the card's power limit
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}


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


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes moved over the HBM rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int):
    """The card's own time per call over `reps` calls after a warm call,
    the host's issue time per call, and whether the host was ahead (the
    probes' timer, `probes.timed`)."""
    from kektordb_tpu_torch.probes import timed
    return timed(torch.device(DEV), fn, reps, warm=1)


def issue_note(t) -> str:
    """The host's side of a timing, for the phase lines."""
    return (f"host issue {t.issue_ms:.4f} ms per call"
            + ("" if t.ahead else ", host NOT ahead: the time holds host "
               "gaps"))


def matmul_ms(torch, q, v) -> float:
    """Device ms of the product alone, a yardstick and not the function:
    torch.matmul of the bf16-rounded operands, q [B, D] x v.T, in chunks
    of MATMUL_CHUNK rows (the skinny probe's shape) into one bf16 output
    per chunk size."""
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    n = vb.shape[0]
    outs = {m: torch.empty((qb.shape[0], m), dtype=torch.bfloat16,
                           device=DEV)
            for m in {min(MATMUL_CHUNK, n - i)
                      for i in range(0, n, MATMUL_CHUNK)}}

    def run():
        for i in range(0, n, MATMUL_CHUNK):
            blk = vb[i:i + MATMUL_CHUNK]
            torch.matmul(qb, blk.T, out=outs[blk.shape[0]])
    return cuda_ms(torch, run, 3).ms


def pass_a_bound(B, N, D, g, q_bytes, v_bytes) -> tuple[float, str]:
    """Pass A's bound: q, the arena and both biases read once, gmin and
    garg written once; 2 B N D operations at the bf16 rate (the forms
    timed multiply bf16-rounded operands)."""
    return bound(B * D * q_bytes + N * D * v_bytes + N * 8
                 + B * (-(-N // g)) * 8, 2.0 * B * N * D, "bf16")


def form_cases(torch, quant, dist):
    """(name, q, v, biasA, biasB, fast, exact) for every pass-A form at
    KERNEL_N rows, then two ragged arenas whose last tile is cut short:
    one with groups of one member, one with groups past the last row
    (scores +inf), then EDGE_CASES. On the card, from SIFT-like draws; a
    tenth of the rows masked."""
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
    cases = [
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
    for label, b, d, arena in EDGE_CASES:
        X = make_sift_like(KERNEL_N + b, d, seed=9)
        v = torch.from_numpy(X[:KERNEL_N]).to(DEV)
        q = torch.from_numpy(X[KERNEL_N:]).to(DEV)
        if arena == "bf16":
            v, q = v.to(torch.bfloat16), q.to(torch.bfloat16)
        bA, bB = scan.serving_bias(v, (v.float() ** 2).sum(-1),
                                   live[:KERNEL_N], dist.L2)
        fast = arena == "f32"
        cases.append((f"{arena}{'_fast' if fast else ''} {label}", q, v,
                      bA, bB, fast, False))
    return cases


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
        worst = max(worst, compare(
            torch, f"{name} D={q.shape[1]} [{scan.pass_a_kernel(form)}]", q,
            v, bA, bB, st, g, form, kern, plain))
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
    dev, wall, top, _ = device_ms(torch, lambda: eng.search(
        "sift", queries[:BATCH], k=K))
    batch_ms = search_s * 1e3 / N_BATCHES
    print(f"phase main: one Engine.search B={BATCH} under the profiler: "
          f"device {dev:.3f} ms in {wall:.3f} ms wall; against the "
          f"unprofiled {batch_ms:.3f} ms batch, idle {1 - dev / batch_ms:.3f}"
          f"; device time by op: {top} [{card}]", flush=True)
    return {"ingest_s": ingest_s, "qps": N_BATCHES * BATCH / search_s,
            "recall": recall, "launches": launches}


def time_pass_a(torch, card: str) -> dict:
    """Phase 5: pass A (fast form, the serving read's candidate pass) at
    the main path's shape, B=4096, N=2^20 (ST=1024, G=16): one kernel
    call held against one plain call as in phase 3, then both timed in
    turns on one card, and the product alone (`matmul_ms`). Returns
    {"ms", "issue_ms", "plain_ms", "matmul_ms", "max_abs_err", "bound_ms",
    "bound_by"}."""
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
        ps.append(cuda_ms(torch, plain, 3).ms)
    kms, pms = sum(t.ms for t in ks) / 2, sum(ps) / 2
    mms = matmul_ms(torch, q, v)
    bms, by = pass_a_bound(HEAD_B, HEAD_N, DIM, g, 4, 4)
    print(f"phase times: pass A B={HEAD_B} N={HEAD_N} D={DIM} fast form "
          f"[{scan.pass_a_kernel(form)}]: kernel "
          + ", ".join(f"{t.ms:.3f}" for t in ks) + f" ms ({issue_note(ks[0])})"
          f", plain {pms:.3f} ms, torch.matmul of the product alone "
          f"{mms:.3f} ms, bound {bms:.3f} ms ({by}) [{card}]", flush=True)
    return {"ms": kms, "issue_ms": ks[0].issue_ms, "plain_ms": pms,
            "matmul_ms": mms, "max_abs_err": err, "bound_ms": bms,
            "bound_by": by}


def hold_gather(torch, label, v, ids, q, metric, **kw):
    """gather-distance (`distance.gathered`, with the keywords `kw` the
    caller's path passes) against its plain version on the same inputs:
    +inf exactly where ids < 0, every other entry within RTOL of
    (|q| + |v|)^2, the sum of the terms' magnitudes. Raises on a
    disagreement; returns (max |err|, its largest share of the tolerance,
    the +inf count)."""
    from kektordb_tpu_torch.ops import distance as dist
    got = dist.gathered(v, ids, q, metric, **kw)
    torch.cuda.synchronize()
    want = dist.gathered_plain(v, ids, q, metric)
    inf_k, inf_p = torch.isinf(got), torch.isinf(want)
    if not torch.equal(inf_k, inf_p) or not torch.equal(inf_k, ids < 0):
        raise AssertionError(f"{label}: +inf positions differ")
    qn = q.float().norm(dim=1)[:, None]
    vn = v.float().norm(dim=1)[ids.clamp_min(0).long()]
    tol = RTOL * (qn + vn) ** 2
    err = (got - want).abs()[~inf_k]
    ratio = float((err / tol[~inf_k]).max())
    if ratio > 1.0:
        raise AssertionError(f"{label}: error {float(err.max())} past "
                             f"tolerance (x{ratio:.3g})")
    return float(err.max()), ratio, int(inf_k.sum())


def check_gather(torch, card) -> dict:
    """Phase 6. Returns {"max_abs_err", "ms", "plain_ms", "bound_ms",
    "bound_by" (the build beam's f32 L2 case, the graph's hottest call),
    "by_shape"}. The bound counts what these ids need: ids, queries and
    outputs once, and one arena row per valid id (f32 or bf16); per valid
    id a dot and |v|^2 (4 D operations, at the f32 rate)."""
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
    worst, times, bounds = 0.0, {}, {}
    for shape, B, C in GATHER_SHAPES:
        ids_np = rng.integers(0, GATHER_N, size=(B, C)).astype(np.int32)
        ids_np[rng.random((B, C)) < GATHER_INVALID] = -1
        ids = torch.from_numpy(ids_np).to(DEV)
        valid = int((ids_np >= 0).sum())
        for dt, row_bytes in (("f32", 4 * DIM), ("bf16", 2 * DIM)):
            bounds[f"{shape} {dt}"] = bound(
                B * C * 8 + B * DIM * 4 + valid * row_bytes,
                valid * 4.0 * DIM, "f32")
        for (dt, metric), (v, qa) in arenas.items():
            q = qa[:B]
            err, ratio, n_inf = hold_gather(
                torch, f"gather {shape} {dt} {metric}", v, ids, q, metric)
            worst = max(worst, err)

            def kernel():
                dist.gathered(v, ids, q, metric)

            def plain():
                dist.gathered_plain(v, ids, q, metric)
            kt = cuda_ms(torch, kernel, 20)
            pms = cuda_ms(torch, plain, 5).ms
            times[f"{shape} {dt} {metric}"] = (kt.ms, pms, kt.issue_ms)
            print(f"phase gather {shape} B={B} C={C} {dt} {metric}: max|err| "
                  f"{err:.6g} ({ratio:.3g} of tol), +inf "
                  f"{n_inf}; kernel {kt.ms:.4f} ms ({issue_note(kt)}), "
                  f"plain {pms:.4f} ms [{card}]", flush=True)
    kms, pms, _ = times[f"{GATHER_SHAPES[0][0]} f32 {dist.L2}"]
    bms, by = bounds[f"{GATHER_SHAPES[0][0]} f32"]
    print("phase gather: bound by case "
          + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items())
          + f" [{card}]", flush=True)
    return {"max_abs_err": worst, "ms": kms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "by_shape": times}


def counted(torch, path: str, fn, need: tuple[str, ...]):
    """Runs one path with every launch count set to 0 just before it and
    reads the counts just after; every kernel in `need` must have launched.
    Returns (fn's result, seconds, counts)."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan, scan_probe
    wrappers = {"gather_dist": dist.gathered, "scan_pass_a": scan.pass_a,
                "scan_vT": scan_probe.scan_vT,
                "scan_reduce": scan_probe.scan_reduce}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    print(f"phase launches, {path}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    missing = [k for k in need if counts[k] < 1]
    if missing:
        raise AssertionError(f"{path}: {missing} never launched")
    return out, sec, counts


def device_ms(torch, fn) -> tuple[float, float, str, int]:
    """(device ms, wall ms, top ops, pass-A launches the trace lacks) of
    one call under torch.profiler: the device time is the sum of the CUDA
    kernels' own times, NaN where the profiler recorded none; top ops
    names the TOP_OPS operators with the most device time, each with its
    share of it, and then how many of the port's kernel launches of the
    call the trace holds (launches through ctypes have no operator of
    their own to show them)."""
    from torch.profiler import ProfilerActivity, profile

    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    before = (scan.pass_a.launches, dist.gathered.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launched = (scan.pass_a.launches - before[0],
                dist.gathered.launches - before[1])
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    traced = [sum(e.count for e in events if e.device_type == cuda
                  and name in e.key)
              for name in ("pass_a", "gather_dist_kernel")]
    seen = (f"; in the trace: scan_pass_a {traced[0]} of {launched[0]} "
            f"launched, gather_dist {traced[1]} of {launched[1]}")
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == cuda) / 1e3
    lost = launched[0] - traced[0]
    if dev <= 0:
        return float("nan"), wall, "none recorded" + seen, lost
    # aten operators own the kernels they launch; the port's own kernels
    # launch through ctypes, outside any operator, so they are read from
    # the kernel events by name
    ops: dict[str, float] = {}
    for e in events:
        if e.device_type != cuda and e.key.startswith("aten::"):
            name = e.key
        elif e.device_type == cuda and "gather_dist_kernel" in e.key:
            name = "gather_dist"
        elif e.device_type == cuda and "pass_a" in e.key:
            name = "scan_pass_a"
        else:
            continue
        ops[name] = ops.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return dev, wall, ", ".join(f"{k} {ms / dev:.1%}" for k, ms in top) \
        + seen, lost


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
    dev, wall, top, _ = device_ms(torch, lambda: idx._commit(
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
    dev, wall, top, _ = device_ms(torch, lambda: idx.search(
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


def probes_phase(torch, card: str) -> dict:
    """Phase 9: the two probe entry points (counted), then scan_vT and
    scan_reduce against their plain versions, and both timed."""
    from kektordb_tpu_torch.ops import scan, scan_probe
    from kektordb_tpu_torch.probes import matmul_ceiling, scan_proto
    mm, _, mm_counts = counted(torch, "probes.matmul_ceiling.run",
                               matmul_ceiling.run, ("scan_vT",))
    sp, _, sp_counts = counted(torch, "probes.scan_proto.run",
                               scan_proto.run, ("scan_reduce",))
    chk = sp["check"]
    if chk["garg_match"] < 1.0 or chk["gmin_err"] > 1e-3:
        raise AssertionError(f"scan_proto's float64 check failed: {chk}")
    for key in ("square", "skinny", "fat"):
        ms = mm[key]["ms"]
        print(f"phase probes: torch.matmul {key} {ms:.3f} ms, "
              f"{mm[key]['flop'] / ms / 1e9:.1f} TFLOP/s [{card}]",
              flush=True)

    gen = torch.Generator(device=DEV).manual_seed(17)
    n_all = PROBE_N + PROBE_RAGGED
    v32 = torch.randn((n_all, DIM), generator=gen, device=DEV)
    v = v32.to(torch.bfloat16)
    bias = (v32 ** 2).sum(1)
    del v32
    q = torch.randn((PROBE_B, DIM), generator=gen, device=DEV).to(
        torch.bfloat16)
    two = torch.full_like(bias, 2.0)
    worst = {"scan_vT": 0.0, "scan_reduce": 0.0}

    def held(name, kern_fn, plain_fn, n, st, g, label=""):
        kern = kern_fn(n, st, g)
        torch.cuda.synchronize()
        plain = plain_fn(n, st, g)
        err = compare(torch, f"{name}{label} N={n}", q, v[:n], bias[:n],
                      two[:n], st, g, scan.FORM_BF16, kern, plain)
        worst[name] = max(worst[name], err)

    vTs = {n: v[:n].T.contiguous() for n in (PROBE_N, n_all)}

    def vt_kern(n, st, g):
        return scan_probe.scan_vT(q, vTs[n], bias[:n], st=st, g=g)

    def vt_plain(n, st, g):
        return scan_probe.scan_vT_plain(q, vTs[n], bias[:n], st=st, g=g)

    def red_kern(n, st, g):
        return scan_probe.scan_reduce(q, v[:n], bias[:n], st=st, g=g)

    def red_plain(n, st, g):
        return scan_probe.scan_reduce_plain(q, v[:n], bias[:n], st=st, g=g)
    for n in (PROBE_N, n_all):
        held("scan_vT", vt_kern, vt_plain, n, *VT_TILE)
    for bt, st, g in scan_proto.TUPLES:      # BT: the TPU's query tile
        held("scan_reduce", red_kern, red_plain, PROBE_N, st, g,
             f" BT={bt}")
    held("scan_reduce", red_kern, red_plain, n_all, *scan_proto.CHECK[1:])

    out = {}
    mms = matmul_ms(torch, q, v[:PROBE_N])
    for name, kern, plain, (st, g) in (
            ("scan_vT", vt_kern, vt_plain, VT_TILE),
            ("scan_reduce", red_kern, red_plain, scan_proto.CHECK[1:])):
        ks, ps = [], []
        for _ in range(2):
            ks.append(cuda_ms(torch, lambda: kern(PROBE_N, st, g), 5))
            ps.append(cuda_ms(torch, lambda: plain(PROBE_N, st, g), 3).ms)
        kms, pms = sum(t.ms for t in ks) / 2, sum(ps) / 2
        # the probes' bias is one f32 vector (biasB is the constant 2)
        bms, by = bound(PROBE_B * DIM * 2 + PROBE_N * DIM * 2 + PROBE_N * 4
                        + PROBE_B * (PROBE_N // g) * 8,
                        2.0 * PROBE_B * PROBE_N * DIM, "bf16")
        print(f"phase probes: {name} B={PROBE_B} N={PROBE_N} D={DIM} "
              f"ST={st} G={g} [wgmma]: kernel "
              + ", ".join(f"{t.ms:.3f}" for t in ks)
              + f" ms ({issue_note(ks[0])}), plain {pms:.3f} ms, "
              f"torch.matmul of the product alone {mms:.3f} ms, bound "
              f"{bms:.3f} ms ({by}) [{card}]", flush=True)
        out[name] = {"ms": kms, "issue_ms": ks[0].issue_ms, "plain_ms": pms,
                     "matmul_ms": mms, "bound_ms": bms, "bound_by": by,
                     "max_abs_err": worst[name], "tile": f"ST={st} G={g}"}
    out["scan_vT"]["launches"] = mm_counts["scan_vT"]
    out["scan_reduce"]["launches"] = sp_counts["scan_reduce"]
    return out


def zipf_texts(rng, n: int) -> list[str]:
    """n texts of WORDS[0]..WORDS[1] words from a VOCAB-word Zipf
    vocabulary (word t{r} has weight 1/(r+1))."""
    p = 1.0 / np.arange(1, VOCAB + 1)
    p /= p.sum()
    lens = rng.integers(WORDS[0], WORDS[1] + 1, size=n)
    words = np.array([f"t{i}" for i in range(VOCAB)])[
        rng.choice(VOCAB, size=int(lens.sum()), p=p)]
    return [" ".join(w) for w in np.split(words, np.cumsum(lens)[:-1])]


def held_to_host(torch, eng, name, Q, alpha, decay, label) -> int:
    """One scan output of Engine's index through the device epilogue
    (fuse.fused_topk) and through the host path (_assemble_fused), at one
    clock reading: scores within FUSE_TOL, ids equal wherever the host's
    adjacent fused scores differ by more. Both take K + 1 hits, so a tie
    across the K-th place is seen; the first K are held. Returns the count
    of hits held."""
    from kektordb_tpu_torch.ops import fuse
    h = eng.indexes[name]
    idx = h.index
    cap = idx._cap
    tr, tv = h.meta.text.search_arrays(TEXT_QUERY)
    keep = tr < cap
    tr, tv = tr[keep], tv[keep]
    d_dev, rows_dev, scale = idx.search_device(Q, 2 * K)
    now = time.time()
    a = alpha if tr.size else 1.0
    sc, rw, dd = fuse.fused_topk(
        d_dev, rows_dev, tr, tv, a, K + 1, scale,
        cap_t=max(eng.TEXT_CAND_CAP, 4 * K),
        decay_dev=eng._decay_device(h, cap) if decay else None, now=now)
    dev = eng._emit_topk(h, idx, sc, rw, dd, Q.shape[0], K + 1, False, True)
    host = eng._assemble_fused(
        h, idx, d_dev.cpu().numpy(), rows_dev.cpu().numpy().astype(np.int64),
        Q.shape[0], K + 1, text_rows=tr, text_vals=tv, alpha=alpha,
        decay=decay, include_metadata=False, columnar=True, now=now)
    hits = 0
    for b in range(Q.shape[0]):
        ds, hs = np.array(dev["scores"][b]), np.array(host["scores"][b])
        if ds.shape != hs.shape or not np.all(np.abs(ds - hs) <= FUSE_TOL):
            raise AssertionError(f"{label}: query {b} fused scores {ds} "
                                 f"against the host's {hs}")
        gap = np.abs(np.diff(hs))
        sep = (np.minimum(np.r_[np.inf, gap], np.r_[gap, np.inf])
               > FUSE_TOL)[:K]
        di, hi = np.array(dev["ids"][b])[:K], np.array(host["ids"][b])[:K]
        if np.any(di[sep] != hi[sep]):
            raise AssertionError(f"{label}: query {b} ids {di} against the "
                                 f"host's {hi}")
        hits += len(hi)
    print(f"phase {label}: device epilogue against the host path "
          f"(_assemble_fused) on one scan output of {Q.shape[0]} queries: "
          f"{hits} hits, scores within {FUSE_TOL}, ids equal where "
          f"separated", flush=True)
    return hits


def hybrid_phase(torch, card: str):
    """Phase 10. Returns (engine, queries) for phase 11, and the max |err|
    of pass A and gather-distance held at this path's shapes."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import fuse
    X = make_sift_like(HYBRID_N + HYBRID_B, DIM, seed=HYBRID_SEED)
    base, Q = X[:HYBRID_N], X[HYBRID_N:]
    rng = np.random.default_rng(HYBRID_SEED)
    texts = zipf_texts(rng, HYBRID_N)
    created = time.time() - rng.uniform(0.0, 30 * DAY, HYBRID_N)
    metas = [{"text": t, "_indexed_fields": ["text"],
              "_created_at": float(c)} for t, c in zip(texts, created)]
    for i in range(0, HYBRID_N, 10):
        metas[i]["_memory_layer"] = "episodic"
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("rag")                        # every default
    t0 = time.perf_counter()
    eng.add_batch("rag", [f"r{i}" for i in range(HYBRID_N)], base, metas)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    eng.search("rag", Q, k=K, text_query=TEXT_QUERY)          # warm
    gt = dist.brute_force_topk(torch.from_numpy(Q).to(DEV),
                               torch.from_numpy(base).to(DEV), K)[1]
    gt = gt.cpu().numpy()
    for alpha in (0.5, 0.0, 1.0):
        fuse.fused_topk.calls = 0
        res, sec, _ = counted(
            torch, f"Engine.search hybrid alpha={alpha}",
            lambda: eng.search("rag", Q, k=K, text_query=TEXT_QUERY,
                               alpha=alpha),
            ("scan_pass_a", "gather_dist"))
        if fuse.fused_topk.calls < 1:
            raise AssertionError("the hybrid search did not take the device "
                                 "epilogue")
        if len(res) != HYBRID_B or any(len(h) != K for h in res):
            raise AssertionError("hybrid search returned a wrong shape")
        if not all(np.isfinite(x["score"]) for h in res for x in h):
            raise AssertionError("hybrid search returned a non-finite score")
        print(f"phase hybrid: {HYBRID_N} rows (ingest with text and graph "
              f"{ingest_s:.3f} s), Engine.search B={HYBRID_B} k={K} "
              f"text_query {TEXT_QUERY!r} alpha={alpha}: "
              f"{HYBRID_B / sec:.1f} QPS, fused_topk calls "
              f"{fuse.fused_topk.calls} [{card}]", flush=True)
        held_to_host(torch, eng, "rag", Q, alpha, False, "hybrid")
        if alpha == 1.0:
            recall = recall_at(np.array([[int(x["id"][1:]) for x in h]
                                         for h in res]), gt)
    # alpha 1 ranks by vector similarity alone (text-only rows score 0 and
    # sort after the vector candidates), so its hits are the scan's
    print(f"phase hybrid: alpha=1 recall@{K} {recall:.4f} on {HYBRID_B} "
          f"queries (exact oracle), min {RECALL_MIN}", flush=True)
    if recall < RECALL_MIN:
        raise AssertionError(f"hybrid alpha=1 recall {recall} < {RECALL_MIN}")
    errs = held_on_path(torch, eng.indexes["rag"].index, Q, "hybrid", card)
    profiled(torch, "hybrid", lambda: eng.search(
        "rag", Q, k=K, text_query=TEXT_QUERY), card,
        eng.indexes["rag"].index, Q)
    return eng, Q, errs


def path_operands(torch, idx, Q):
    """What a scan search of the f32 index `idx` hands pass A for the
    queries Q (a power-of-two batch, so not padded, and under the
    chunking limit): (q, qn, biasA, biasB, st, g), the index's own arena
    `idx.state.vectors` being the fifth operand."""
    from kektordb_tpu_torch.ops import scan
    s = idx.state
    q, qn = idx._encode_query(idx._queries(Q))
    bA, bB = scan.serving_bias(s.vectors, s.norms,
                               (s.levels >= 0) & ~s.deleted, idx.metric)
    return (q, qn, bA, bB, *scan.kernel_tiles(s.vectors.shape[0]))


def held_on_path(torch, idx, Q, label: str, card: str) -> dict:
    """Pass A and gather-distance at the shapes a hybrid or decayed search
    of `idx` gives them, each held against its plain version: pass A in
    the fast form on the index's own arena and biases (as in phase 3),
    timed there beside its bound and the product alone, then the
    re-rank's gather of RERANK_C candidates from pass B's rows (as in
    phase 6). Returns each kernel's max |err|."""
    from kektordb_tpu_torch.ops import scan
    q, qn, bA, bB, st, g = path_operands(torch, idx, Q)
    v = idx.state.vectors
    form = scan.pass_a_form(q.dtype, v.dtype, fast=True)
    kern = scan.pass_a(q, v, bA, bB, st=st, g=g, fast=True)
    torch.cuda.synchronize()
    plain = scan.pass_a_plain(q, v, bA, bB, st=st, g=g, form=form)
    err_a = compare(torch, f"{label} search's pass A "
                    f"[{scan.pass_a_kernel(form)}]", q, v, bA, bB, st, g,
                    form, kern, plain)
    del kern, plain
    t = cuda_ms(torch, lambda: scan.pass_a(q, v, bA, bB, st=st, g=g,
                                           fast=True), 5)
    bms, by = pass_a_bound(q.shape[0], v.shape[0], v.shape[1], g, 4, 4)
    print(f"phase {label}: pass A at the search's shape (B={q.shape[0]}, "
          f"N={v.shape[0]}, ST={st}, G={g}): kernel {t.ms:.3f} ms "
          f"({issue_note(t)}), torch.matmul of the product alone "
          f"{matmul_ms(torch, q, v):.3f} ms, bound {bms:.3f} ms ({by}) "
          f"[{card}]", flush=True)
    _, rows = scan._scan_kernel(q, v, bA, bB, RERANK_C, fast=True)
    err_g, ratio, n_inf = hold_gather(
        torch, f"{label} search's re-rank", v, rows, q, idx.metric,
        corpus_norms=idx.state.norms, query_norms=qn)
    print(f"phase {label}: re-rank gather-distance B={q.shape[0]} "
          f"C={rows.shape[1]} against its plain version: max|err| "
          f"{err_g:.6g} ({ratio:.3g} of tol), +inf {n_inf}", flush=True)
    return {"scan_pass_a": err_a, "gather_dist": err_g}


def profiled(torch, label: str, fn, card: str, idx, Q) -> None:
    """Three calls of fn unprofiled (host clock, the median kept), then
    one under the profiler: device time and idle share as traced, against
    the unprofiled median, and the operators with the most device time.
    Where the trace lacks pass-A launches of the call (seen on the card in
    this script, not when the phase ran alone), pass A at the search's
    shape is timed alone by CUDA events and traced alone, and both are
    printed on a line of their own; neither enters the traced figures."""
    from kektordb_tpu_torch.ops import scan
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_ms = float(np.median(walls))
    dev, wall, top, lost = device_ms(torch, fn)
    print(f"phase {label}: one Engine.search B={HYBRID_B} under the "
          f"profiler: device {dev:.3f} ms as traced in {wall:.3f} ms wall; "
          f"against the unprofiled median {plain_ms:.3f} ms (of "
          + ", ".join(f"{w:.3f}" for w in walls)
          + f"), idle {1 - dev / plain_ms:.3f} as traced; device time by "
          f"op: {top} [{card}]", flush=True)
    if lost:
        q, _, bA, bB, st, g = path_operands(torch, idx, Q)

        def one():
            scan.pass_a(q, idx.state.vectors, bA, bB, st=st, g=g, fast=True)
        alone = cuda_ms(torch, one, 5).ms
        _, _, _, lost_alone = device_ms(torch, one)
        print(f"phase {label}: the trace lacks {lost} pass-A launch(es) of "
              f"the search; pass A alone at its shape (B={q.shape[0]}, "
              f"N={idx.state.vectors.shape[0]}): {alone:.3f} ms per call by "
              f"CUDA events, not in the figures above; traced alone under "
              f"the profiler: {1 - lost_alone} of 1 launch [{card}]",
              flush=True)


def decay_phase(torch, eng, Q, card: str) -> None:
    """Phase 11 on phase 10's engine."""
    from kektordb_tpu_torch.ops import fuse
    eng.configure_index("rag", {"memory": {
        "enabled": True, "decay_half_life": DAY,
        "layers": {"episodic": {"decay_half_life": 3 * DAY,
                                "decay_model": "ebbinghaus"}}}})
    fuse.build_decay_device.calls = fuse.update_decay_device.calls = 0
    res, sec, _ = counted(torch, "Engine.search decayed",
                          lambda: eng.search("rag", Q, k=K),
                          ("scan_pass_a", "gather_dist"))
    if fuse.build_decay_device.calls != 1:
        raise AssertionError("the first decayed search did not build the "
                             "mirror")
    print(f"phase decay: Engine.search B={HYBRID_B} k={K} decayed: "
          f"{HYBRID_B / sec:.1f} QPS (mirror built) [{card}]", flush=True)
    held_to_host(torch, eng, "rag", Q, 0.5, True, "decay")
    for rnd in range(1, REINFORCE_ROUNDS + 1):
        for hits in res[:REINFORCED]:
            eng.reinforce("rag", hits[0]["id"])
        res, sec, _ = counted(
            torch, f"Engine.search decayed, after reinforce round {rnd}",
            lambda: eng.search("rag", Q, k=K), ("scan_pass_a", "gather_dist"))
        print(f"phase decay: after reinforce of {REINFORCED} top hits "
              f"(round {rnd}): {HYBRID_B / sec:.1f} QPS; mirror builds "
              f"{fuse.build_decay_device.calls}, refreshes in place "
              f"{fuse.update_decay_device.calls} [{card}]", flush=True)
        if fuse.build_decay_device.calls != 1 \
                or fuse.update_decay_device.calls != rnd:
            raise AssertionError("a decay refresh after reinforce was not "
                                 "incremental")
        if len(res) != HYBRID_B or any(len(h) != K for h in res):
            raise AssertionError("decayed search returned a wrong shape")
        held_to_host(torch, eng, "rag", Q, 0.5, True, "decay")
    qps = []
    for _ in range(STEADY):
        _, sec, _ = counted(torch, "Engine.search decayed, steady",
                            lambda: eng.search("rag", Q, k=K),
                            ("scan_pass_a", "gather_dist"))
        qps.append(HYBRID_B / sec)
    print(f"phase decay: {STEADY} more decayed searches, mirror fresh: "
          + ", ".join(f"{x:.1f}" for x in qps) + f" QPS [{card}]",
          flush=True)
    profiled(torch, "decay", lambda: eng.search("rag", Q, k=K), card,
             eng.indexes["rag"].index, Q)
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
    print(f"phase build: {lib.name} in {build_s:.3f} s (one nvcc per "
          "source, in parallel, then one link)", flush=True)
    for ln in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"phase build: {ln.strip()}", flush=True)

    max_err = check_kernels(torch)
    main = main_path(torch, card)
    head = time_pass_a(torch, card)
    max_err = max(max_err, head["max_abs_err"])
    print(f"phase times: ingest {main['ingest_s']:.3f} s, Engine.search "
          f"{main['qps']:.1f} QPS at B={BATCH}, recall@{K} "
          f"{main['recall']:.4f} [{card}]", flush=True)
    gather = check_gather(torch, card)
    graph = graph_path(torch, card)
    vacuum_and_import(torch, card)
    probes = probes_phase(torch, card)
    eng, Q, path_errs = hybrid_phase(torch, card)
    decay_phase(torch, eng, Q, card)

    leaked = [m for m in sys.modules
              if m in ("jax", "jaxlib", "kektordb_tpu")
              or m.startswith(("jax.", "jaxlib.", "kektordb_tpu."))]
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")
    print(f"phase total: {time.perf_counter() - t_start:.1f} s [{card}]",
          flush=True)
    # no single PyTorch call computes any of these kernels' functions
    # (a fused product + group min / argmin; a gather + distance), so
    # library_ms is null for each; matmul_ms times the product alone, a
    # yardstick of pass A's tensor-core work
    kernels = [{
        "name": "scan_pass_a", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/scan_pass_a_wgmma.cu",
        "replaces": "kektordb_tpu/ops/scan.py:175",
        "launches": main["launches"],
        "max_abs_err": max(max_err, path_errs["scan_pass_a"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "issue_ms": head["issue_ms"],
        "matmul_ms": head["matmul_ms"],
        "other_forms_source": "kektordb_tpu_torch/csrc/scan_pass_a.cu"}, {
        "name": "gather_dist", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/gather_dist.cu",
        "replaces": "scripts/pallas_gather.py:120, "
                    "scripts/pallas_gather2.py:170",
        "launches": graph["beam_launches"],
        "max_abs_err": max(gather["max_abs_err"], path_errs["gather_dist"]),
        "ms": gather["ms"],
        "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
        "bound_by": gather["bound_by"], "library_ms": None,
        "ms_by_case": {k: v[0] for k, v in gather["by_shape"].items()},
        "plain_ms_by_case": {k: v[1] for k, v in
                             gather["by_shape"].items()},
        "issue_ms_by_case": {k: v[2] for k, v in
                             gather["by_shape"].items()}}]
    for name, replaces in (("scan_vT", "scripts/matmul_ceiling.py:90"),
                           ("scan_reduce", "scripts/scan_pallas_proto.py:46")):
        pr = probes[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kektordb_tpu_torch/csrc/scan_pass_a_wgmma.cu",
            "replaces": replaces, "launches": pr["launches"],
            "max_abs_err": pr["max_abs_err"], "ms": pr["ms"],
            "plain_ms": pr["plain_ms"], "bound_ms": pr["bound_ms"],
            "bound_by": pr["bound_by"], "library_ms": None,
            "issue_ms": pr["issue_ms"], "matmul_ms": pr["matmul_ms"],
            "timed_at": pr["tile"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
