#!/usr/bin/env python3
"""Smoke test of the PyTorch port (kektordb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, one line each; any failure exits non-zero:
  1 device  the card's name and power limit (nvidia-smi)
  2 build   nvcc builds kektordb_tpu_torch/csrc into build/, one compiler
            per source at once, then one link (timed); g++ builds the host
            runtime (csrc/host/kektor_native.cpp, host_native.py; timed)
  3 kernel  pass A (csrc/scan_pass_a_wgmma.cu, every form on the tensor
            cores; each line names its product) against its plain PyTorch
            version on the card, B=256, N=2^17, D=128, in every precision
            form, and on two arenas whose last tile is ragged (N=2^17+77,
            fast and f32 exact; 2^17+37, int8 and asym exact), each form
            also at G=7 (a last member pair of one member); then the
            kernel's edges (EDGE_CASES): B=200 (a last query slab cut
            short), D=100 (a depth tail; for int8 100-byte rows, which no
            16-byte copy takes), D=768 / 2048 (a query slab streamed with
            each depth chunk), a bf16 arena at D=100 (200-byte rows),
            int8 D=384, asym exact D=384 and 768 (its three query pieces
            streamed), bf16 at the projected read's small depths D=8, 16,
            24 and 32 (one k16 step at most; 16- to 64-byte rows), the
            host arena's projected mirror (form 5, an f32 query against
            32-byte int8 rows, B=256 and 200); int8 x int8 must be
            bit-equal; then an arena with
            every row masked (inf, rows -1). Then pass B's tie order: an
            arena of 2^17 rows, each of 2^15 rows repeated 4 times, k=8
            and 10, pass B (scan.pass_b) equal to a stable sort of the
            same gmin, and _scan_kernel's rows those positions' rows
  4 main    the Engine's read path at SIFT-1M width: an hnsw index with
            serve_mode="scan", add_batch of 1,000,000 x 128 SIFT-like f32
            vectors (ids v{i}, seed 1234), 8 searches of 4096 queries,
            k=10; recall@10 against the exact oracle on 1024 queries must
            be >= 0.99 and the hits' distances must agree with the
            oracle's, the pass-A launch count must have grown, and a
            filtered search must return only rows that satisfy the
            filter; one search under the profiler (device time by op)
 13 exact   phase 4's index with scan_exact (pass A's f32 exact form, no
            re-rank), 8 searches of 4096 queries: recall@10 >= 0.99,
            distances as phase 4's, QPS, form 0 launched (runs after 4)
  5 times   pass A at the main path's shape (B=4096, N=2^20, fast form)
            checked against the plain version as in phase 3, then kernel,
            plain and torch.matmul of the product alone timed; pass B on
            that output (k=32) held to a stable sort and timed against the
            bare torch.topk it replaced (CUDA events, and its kernels'
            device time under torch.profiler); the exact forms 0 (3xTF32) and 4
            (three bf16 pieces) and int8 x int8 (s8) the same way, each
            with its bound (bytes, or the products it issues at their
            type's rate) and, for int8, torch._int_mm of the product alone;
            ingest seconds, Engine.search QPS at B=4096
  6 gather  gather-distance (csrc/gather_dist.cu) against its plain
            version at the cases of probes.gather_cold: the graph's three
            shapes (build beam B=512 C=256, serving beam B=1024 C=128, scan
            re-rank B=4096 C=32) on f32 and bf16 arenas of 2^20 SIFT-like
            rows, L2 and cosine, 40% of ids -1; the TPU scripts' shape
            (B=4096 C=256, bf16, all ids valid and 40% -1); bf16 D=100
            (4-byte chunks) and f32 D=768 (long rows); and, check only,
            int64 ids, a bf16 query on an f32 arena, the arena one element
            off a 16-byte boundary (4-byte chunks for f32, the scalar route
            for bf16), C=1 and a ragged B, C, and ids past the arena (+inf);
            and the projected read's re-rank (B=1024 C=128, D=384 f32):
            the same +inf positions and every entry within RTOL of
            |q|^2 + |v|^2 + 2|q||v|. Kernel and plain timed with cold rows:
            the calls rotate over enough fresh id sets that the others
            touch 4x the 50 MB L2 between two uses of one; each case's
            bound and share of it printed
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
            (the three torch.matmul ceilings and scan_vT,
            csrc/scan_pass_a_wgmma.cu over a transposed bf16 arena) and
            .scan_proto (scan_reduce, pass A's bf16 form, at the 7 (BT,
            ST, G) of the script's sweep, and its float64 check), at B=4096, N=2^20, D=128; then scan_vT at
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
            search's shapes (B=1024 over the index's own 2^18-row arena;
            the re-rank's 32 candidates) held against their plain versions
            as in phases 3 and 6; one search under the profiler
 11 decay   the same engine: configure_index(memory: decay_half_life 1 day,
            an "episodic" layer); a decayed search at B=1024 (mirror built),
            then REINFORCE_ROUNDS times: reinforce of 64 queries' top hits
            and the search again (mirror refreshed in place:
            update_decay_device, no rebuild); each against the host path
            as in phase 10; QPS of each and of STEADY more; one under the
            profiler
 12 bf16    the default index at precision "bfloat16" (bf16 arena, bf16
            queries): add_batch of BF16_N SIFT-like rows (seed 1237), timed;
            Engine.search B=4096 (scan) recall@10 >= 0.99 and beam B=1024,
            ef_search=100, recall@10 >= 0.95, QPS, both against the exact
            oracle over the f32 rows; one more build chunk under the
            profiler with each gather-distance call in a record_function
            range: the chunk's kernels by name, gather-distance's share of
            its device time, and no kernel but gather-distance's inside a
            range (the wrapper launches no conversion); then
            optimize_layout (BFS relabel): beam QPS before and after, the
            same ids in the same order for >= 99% of the queries
 14 int8    bench.py's cosine collection (400,000 x 384, 4,096 centroids,
            noise 0.35, seed 99, rows normalized) in an index of precision
            "int8", serve_mode "scan", int8_symmetric: Engine.search at
            B=1024, k=10, QPS, recall@10 against the exact scan over the
            same int8 codes >= 0.99 and against the f32 cosine oracle
            (reported), form 3 launched; form 3 bit-equal to its plain
            version at the search's shape (B=1024, the 2^19-row arena,
            D=384) and timed; the same index with int8_symmetric off and
            scan_exact on (form 4), recall reported, form 4 launched, and
            form 4 held against its plain version at that shape and timed
 15 persist phase 7's index (after 7): a checkpoint of it (index_io +
            checkpoint, timed, bytes) under a temporary directory of build/,
            Engine(data_dir) opened over it (timed to the first search);
            50,000 journaled adds (SIFT-like, seed 1240, graph linked),
            1,000 deletes, 100 metadata patches, KV sets and links, one
            VCONFIG; the journal flushed by the writer's own thread, the
            engine dropped without close() (a crash); the journal scanned
            by the host runtime's C++ frame scanner and by the Python one
            (equal frames, no corrupt region; both timed, with their
            shares of the replay), and a corrupted copy of it (a zeroed
            stretch mid-journal, a torn tail: equal frames and regions);
            reopened (checkpoint + replay on the C++ scanner, its calls
            and gather-distance's launches counted: replay seconds,
            rows/s), closed (a checkpoint, timed) and reopened (checkpoint
            only); after each reopen the B=1024 scan read as the writer
            gave it (ids except adjacent ties, distances within RTOL), every
            acknowledged vector bit-equal, deletes gone, KV / links /
            metadata / VCONFIG back, beam recall@10 >= 0.95; then
            compress_serving("int8"): recall@10 against the f32 oracle >=
            0.90, a checkpoint and a reopen with the same reads; then the
            host runtime's exact top-k (host_native.bruteforce_topk) on
            256 of phase 4's queries over 100,000 of its rows against the
            card's distance.brute_force_topk: ids equal but for ties,
            distances within RTOL of the terms' magnitudes (both timed)
 16 proj    bench.py's anisotropic collection (400,000 x 384 cosine rows,
            power-law spectrum, seed 424242), serve_mode "scan",
            serve_proj_dim 32, serve_proj_rerank 128: Engine.search at
            B=1024, k=10: QPS and recall@10 against the exact oracle (>=
            0.90) beside the full-dimension read of the same index; pass
            A's bf16 form at D=32 over the projected arena and the re-rank's
            gather-distance (C=128, D=384) held against their plain
            versions and timed beside their bounds
 17 host    the host-RAM arena (kind="host", pinned host memory streamed
            through a ring of SYNC_EVERY device chunks by a copy stream)
            through the Engine: bench.py's host configuration, every
            default, on phase 4's rows (the projected int8 mirror switches
            itself on, p=32) and the same rows with serve_proj_dim=0 (the
            full-dimension sweep, recall@10 >= 0.99), B=4096, QPS and
            recall against phase 4's oracle; bench.py's anisotropic pair
            on phase 16's collection (proj_dim 0, and 32 with rerank 128:
            recall >= 0.90), B=1024; each read timed by part (bytes
            streamed, H2D GB/s beside a bare pinned copy_ of the same
            bytes, copies / scans / merges by CUDA events, how much of the
            copies ran under the scans, the host re-rank, the device's
            idle share under torch.profiler); launches per path (form 1 and
            gather-distance on the full sweep, form 5 on the projected
            ones, forms 3 and 2 on int8 / bf16); form 1 over one chunk,
            its re-rank's gather-distance (C=10) and form 5 over the mirror
            (B=4096 and 1024) held to their plain versions and timed
            beside their bounds; deletes and a filter across the full
            index's chunks; int8 and bf16 host indexes of 300,000 rows
            held to the exact scan of their stored rows (>= 0.99) and
            reported against the f32 oracle; the default index through a
            checkpoint under build/: the same reads, every vector
            bit-equal, the auto projection kept
 18 server  make_app over an Engine on the card, on 127.0.0.1:0: every
            step of testdata/contracts.json; phase 4's index over HTTP at
            bench.py's shapes (16 concurrent plain requests of B=512, 8
            columnar of B=2048 with base64 queries, the same with
            wire="b64", 64 one-query requests through the QueryBatcher):
            QPS of each, every answer's ids Engine.search's for the same
            queries (except adjacent ties), the batcher's stats;
            /debug/profile for 1 s under HTTP searches: a Chrome trace
            with the port's CUDA kernels; the CLI as subprocesses: `python
            -m kektordb_tpu_torch serve` with a data dir (create, add,
            search, SIGTERM, restart, every vector read back bit-equal)
            and `mcp` over stdio (61 tools, a vector tool call)
 19 minilm  the MiniLM encoder (services/minilm.py) at all-MiniLM-L6-v2's
            widths (vocab 30,522, dim 384, 6 layers, 12 heads,
            intermediate 1,536), seeded random weights, a word-hash
            tokenizer: B=256 at T=128 and B=64 at T=256, mean and CLS
            pooling: embeddings/s (encode, and the forward alone), the
            first 64 rows held to the port's CPU forward (max|err| <=
            1e-5); then MiniLMEmbedder on the card feeds a 4,096-document
            cosine Engine index and 64 texts return their own documents
 20 shards  with KEKTOR_TORCH_DEVICE_REPEAT=4 (cuda:0 four times): (a)
            phase 4's rows through Engine.create_index(shards=4), scan:
            QPS beside phase 4's, recall@10 >= 0.99, pass A exactly 4
            launches a search; scan_exact against phase 13's ids (ties and
            at most 1% group-collision places excused); a filtered search;
            pass A and the re-rank held at one shard's shape; (b) a
            sharded graph index of 4 x 25,000 rows: build launches per
            chunk, beam recall@10 no more than 0.01 below one index's
            over the same rows; the projected scan (p=32, one
            basis for all shards) recall >= 0.90; an int8 cosine index of
            the 1M rows, one quantizer for all shards, form 3 once per
            shard and search, recall >= 0.99 against the exact scan of the
            same codes; (c) the Engine with shards=4 and a data dir:
            add with text, hybrid search, deletes, checkpoint, a reopen
            that comes back sharded, every vector bit-equal; (d) two
            processes on the card in one gloo group (2 replicas x 2
            shards, 280,000 rows): ReplicatedServing.search QPS, the ids
            of the single-process sharded search, verify_replicas equal;
            every child with a timeout
 21 serve   the port as `serve` deploys it, the background thread on:
            (a) phase 15's index (1,000,000 + 50,900 rows, its data dir
            copied after its close) opened with snapshot_interval 5 and
            maintenance_interval 1; 3 readers (Engine.search B=4096, B=1,
            B=1024 filtered) until 2 writers end, each 8 add_batch of
            1,024 SIFT-like rows (seed 1242), 2,000 adds, 2,000 deletes and
            200 metadata patches, each acknowledgement timed: no thread
            raises, no ERROR on the kektordb logger, at least one snapshot
            by the background thread, every hit a known id with a finite
            score and not deleted before its search began; after
            run_maintenance scan recall@10 >= 0.99 and beam >= 0.95
            against the exact oracle over the live rows; close() and a
            reopen: every acknowledged add back and bit-equal, every
            acknowledged delete gone; (b) phase 11's engine: 2 threads of
            decayed B=1024 searches beside a third reinforcing 64 hits a
            round, 20 rounds at a fixed clock, each search held to the
            host path; phase 17's default host index: 8 B=4096 batches in
            2 threads at once, ids equal to a serial run's; (c) a child
            process of the port alone on the card (its background thread
            on) ingests add_batch of 4,096 (seed 1243) and single adds,
            each fsynced and acknowledged, and is SIGKILLed after 32
            batches and 200 single adds while it writes (it prints its
            device and launch counts); reopened on the
            card: every acknowledged id back, bit-equal, its own nearest
            row; the beam serves and leaves no backlog
Kernel times are the card's own: the timed calls queue behind a sleep
kernel so the host is ahead (kektordb_tpu_torch.probes.timed), and the
host's issue time per call is printed beside each. Each path of phases
7 to 21 (the build, the scan search, the beam, vacuum, import, the two
probes, the hybrid and decayed searches, the bf16 build and beam, the
exact and int8 searches, the journaled adds, their replay, the beams on
reopened indexes, the compressed and projected reads, the host sweeps, the
HTTP reads, the sharded reads and build, the serving storm and the
threaded reads) runs with every launch
count set to 0 just
before it; its counts (pass A's also by form) are read and printed just
after, and a kernel (or pass-A form) the path runs must have launched.
Then a JSON line of the kernels, pass A's exact and int8 forms each on
a line of its own (each with its bound: the larger of its bytes over the
HBM rate and its operations over the peak rate of their type), the
card's line, and as the last line {"ok": true, "device": {...}}. Exits
non-zero, printing no result, where torch sees no CUDA device. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import logging
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
PASS_B_N = 1 << 17   # rows of pass B's tie check (each repeated 4 times)
RTOL = 1e-5
DEV = "cuda"
# phase 3's edges of the tensor-core kernel: (label, B, D, kind); kinds:
# f32_fast (form 1), bf16 (2), f32 (form 0, exact), int8 (3), asym (4,
# exact); a last query slab cut short, a depth tail, a query slab
# streamed with each depth chunk, rows of a stride no 16-byte copy takes,
# the projected read's small depths (at most one bf16 k16 step, rows of
# 16 to 64 bytes), and the host arena's projected mirror (asym_fast, form
# 5: an f32 query against 32-byte int8 rows)
EDGE_CASES = (("B=200", 200, DIM, "f32_fast"),
              ("depth tail", KERNEL_B, 100, "f32_fast"),
              ("streamed query slab", KERNEL_B, 768, "f32_fast"),
              ("200-byte rows", KERNEL_B, 100, "bf16"),
              ("small depth", KERNEL_B, 8, "bf16"),
              ("small depth", KERNEL_B, 16, "bf16"),
              ("small depth", KERNEL_B, 24, "bf16"),
              ("small depth", KERNEL_B, 32, "bf16"),
              ("B=200", 200, DIM, "f32"),
              ("depth tail", KERNEL_B, 100, "f32"),
              ("streamed query slab", KERNEL_B, 768, "f32"),
              ("B=200", 200, DIM, "int8"),
              ("100-byte rows", KERNEL_B, 100, "int8"),
              ("D=384", KERNEL_B, 384, "int8"),
              ("streamed query slab", KERNEL_B, 2048, "int8"),
              ("B=200", 200, DIM, "asym"),
              ("100-byte rows", KERNEL_B, 100, "asym"),
              ("D=384", KERNEL_B, 384, "asym"),
              ("streamed query slab", KERNEL_B, 768, "asym"),
              ("projected mirror", KERNEL_B, 32, "asym_fast"),
              ("B=200 projected mirror", 200, 32, "asym_fast"))
# phase 3: the per-form cases also run at this odd G (ST = 64 G)
FORM_NAMES = ("f32", "f32_fast", "bf16", "int8", "asym", "asym_fast")
ODD_G = 7
MATMUL_CHUNK = 1 << 17   # rows per torch.matmul of the product yardstick
# phase 6: the SIFT-like arena's rows (the cases: probes.gather_cold.CASES)
GATHER_N = 1 << 20
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
# cut from 500,000 rows to leave the script's time limit room for the
# persistence and projected-read phases
HYBRID_N, HYBRID_B, HYBRID_SEED = 250_000, 1024, 1236
STEADY = 3           # decayed searches timed once the mirror is fresh
REINFORCE_ROUNDS = 2
VOCAB, WORDS = 5000, (8, 16)
TEXT_QUERY = "t40 t300 t1200"
DAY = 86400.0
REINFORCED = 64
# phase 14: bench.py's cosine / int8 collection (bench.py:733-800)
INT8_N, INT8_DIM, INT8_CENTROIDS, INT8_NOISE, INT8_SEED = \
    400_000, 384, 4096, 0.35, 99
INT8_B, INT8_BATCHES = 1024, 8      # the two query batches, 4 times
# phase 15: the journal written over phase 7's checkpointed index
PERSIST_ADDS, PERSIST_DELETES, PERSIST_PATCHES = 50_000, 1_000, 100
PERSIST_SEED, PERSIST_B, PERSIST_EF = 1240, 1024, 128
# the journal's order cases: links of PERSIST_LINKS ids made before their
# delete, after their re-add, and from rows deleted later; a second default
# index of SECOND_N rows dropped and created again with SECOND_N others; a
# host index created empty, given HOST_LAZY_ROWS rows after the reopens
PERSIST_LINKS, SECOND_N, HOST_LAZY_ROWS = 100, 20_000, 4096
HOST_TOPK_B, HOST_TOPK_N = 256, 100_000   # the host runtime's exact top-k
INT8_COMPRESS_RECALL_MIN = 0.90
# phase 16: bench.py's anisotropic collection (bench.py:819-900)
PROJ_N, PROJ_DIM, PROJ_SEED = 400_000, 384, 424242
PROJ_P, PROJ_RERANK, PROJ_B, PROJ_BATCHES = 32, 128, 1024, 8
PROJ_RECALL_MIN = 0.90
# phase 17: the host arena (bench.py:916-986): B=BATCH searches of each
# read, the full-dimension index's deletes (every HOST_DELETE_EVERY-th
# row), and the int8 / bf16 host indexes of HOST_SPAN_N rows (2 chunks)
HOST_BATCHES, HOST_DELETE_EVERY = 4, 100
HOST_SPAN_N = 300_000
# phase 18: bench.py's HTTP shapes (bench.py:120-170), the one-query
# requests the QueryBatcher coalesces, the profile's seconds, and the
# CLI's rows and start limit
HTTP_PLAIN, HTTP_PLAIN_B, HTTP_COL, HTTP_COL_B = 16, 512, 8, 2048
HTTP_SINGLE, PROFILE_S = 64, 1
CLI_N, CLI_SEED, CLI_START_S = 2000, 1241, 240
# phase 19: all-MiniLM-L6-v2's widths (its config.json), seeded random
# weights; the (B, T) batch shapes (T = 256 is the encoder's MAX_LEN); the
# rows held to the CPU forward, and the tolerance (f32 both, TF32 off);
# the documents of the Engine check
MINILM = dict(vocab_size=30522, dim=384, n_layers=6, n_heads=12,
              intermediate=1536, max_pos=512)
MINILM_SEED, MINILM_REPS, MINILM_DOCS = 1250, 5, 4096
MINILM_SHAPES = ((256, 128), (64, 256))
MINILM_CHECK_ROWS, MINILM_ATOL = 64, 1e-5
# phase 20: shards on one card (the device-repeat setting); the graph
# index's rows; the sharded Engine's rows with text; the replicas: two
# processes of two shards each, over REPLICA_N of phase 4's rows (past
# 250,000 so that both shards of a replica reach the kernel route's 2^17)
SHARDS, SHARD_GRAPH_N, SHARD_BEAM_SLACK = 4, 4 * 25_000, 0.01
SHARD_ENGINE_N, SHARD_ENGINE_SEED = 20_000, 1251
REPLICAS, REPLICA_SHARDS, REPLICA_N = 2, 2, 280_000
REPLICA_SEARCHES, CHILD_TIMEOUT_S = 4, 300
# phase 21: the server as deployed. (a) the storm on phase 15's index: each
# writer's rounds (one add_batch of SERVE_BATCH rows, then its share of the
# single adds, deletes and metadata patches), the readers' (B, filter), the
# background thread's intervals; (b) the decay rounds, the host batches a
# thread; (c) the SIGKILLed child's add_batch rows and batches (32 x 4,096
# rows = 2^17: its arena reaches pass A's route, PALLAS_MIN_ROWS), the
# single adds before the kill, and the vectors it holds for them
SERVE_SEED, SERVE_WRITERS, SERVE_ROUNDS, SERVE_BATCH = 1242, 2, 8, 1024
SERVE_SINGLES, SERVE_DELETES, SERVE_PATCHES = 2000, 2000, 200
SERVE_READS = ((BATCH, None), (1, None), (RECALL_QUERIES, "grp = 1"))
SERVE_SNAPSHOT_S, SERVE_MAINTENANCE_S = 5, 1
DECAY_THREAD_ROUNDS, HOST_THREAD_BATCHES = 20, 8
KILL_SEED, KILL_BATCH, KILL_BATCHES, KILL_SINGLES = 1243, 4096, 32, 200
KILL_POOL = 20_000
# phase 12: rows of the bf16 default index (cut from 500,000 to 2^18, still
# past pass A's route at 2^17, to leave the script's time limit room for
# phase 21)
BF16_N, BF16_SEED = 1 << 18, 1237
LAYOUT_SAME_MIN = 0.99
FUSE_TOL = 1e-5
RERANK_C = 32        # the scan re-rank's candidates (kf) at k = 2 * K
# the bound: NVIDIA's H100 SXM figures (dense), at the card's power limit
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12,
              "int8": 1979e12}


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


def form_bound(scan, form, B, N, D, g, q_bytes, v_bytes):
    """A pass-A form's bound: q, the arena and both biases read once, gmin
    and garg written once; the operations are the products the kernel
    issues, 2 B N D each, at the peak rate of their type
    (`scan.FORM_PRODUCTS`)."""
    kind, passes = scan.FORM_PRODUCTS[form]
    return bound(B * D * q_bytes + N * D * v_bytes + N * 8
                 + B * (-(-N // g)) * 8, passes * 2.0 * B * N * D, kind)


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
        (f"f32 N={r_long}", q32, *rows(r_long, v32, l2), False, False),
        (f"int8 N={r_short}", qcodes, *rows(r_short, codes, cos8),
         False, False),
        (f"asym N={r_short}", qn, *rows(r_short, codes, cos8), False, True),
    ]
    gen = torch.Generator(device=DEV).manual_seed(9)
    for label, b, d, kind in EDGE_CASES:
        if kind in ("int8", "asym", "asym_fast"):   # unit Gaussian rows
            v = dist.normalize(torch.randn((KERNEL_N, d), generator=gen,
                                           device=DEV))
            q = dist.normalize(torch.randn((b, d), generator=gen,
                                           device=DEV))
            st8 = quant.train(v)
            v, vnorms = quant.quantize(st8, v)
            if kind == "int8":
                q = quant.quantize(st8, q)[0]
            bA, bB = scan.serving_bias(v, vnorms, live[:KERNEL_N],
                                       dist.COSINE)
        else:
            X = make_sift_like(KERNEL_N + b, d, seed=9)
            v = torch.from_numpy(X[:KERNEL_N]).to(DEV)
            q = torch.from_numpy(X[KERNEL_N:]).to(DEV)
            if kind == "bf16":
                v, q = v.to(torch.bfloat16), q.to(torch.bfloat16)
            bA, bB = scan.serving_bias(v, (v.float() ** 2).sum(-1),
                                       live[:KERNEL_N], dist.L2)
        cases.append((f"{kind} {label}", q, v, bA, bB, kind == "f32_fast",
                      kind == "asym"))
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


def product(scan, form) -> str:
    """The tensor-core product a pass-A form issues, for the lines."""
    kind, passes = scan.FORM_PRODUCTS[form]
    return f"{passes}x{kind}" if passes > 1 else kind


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
    scale = float(bA[fin].abs().max()) + float(bB[fin].abs().max()) * float(
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
    if form == scan.FORM_INT8 and (err or nbad):
        # the s32 sum is exact: int8 x int8 must be bit-equal
        raise AssertionError(f"{name}: int8 x int8 not bit-equal (max|gmin "
                             f"err| {err}, {nbad} argmins differ)")
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
    exact = ", bit-equal" if form == scan.FORM_INT8 else ""
    print(f"phase kernel {name}: B={q.shape[0]} N={v.shape[0]} ST={st} "
          f"G={g} form {form} ({product(scan, form)}), max|gmin err| "
          f"{err:.6g} (tol {tol:.6g}{exact}), "
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
        # the form's cases at the GPU's tiles, and the first six (one per
        # form) also at an odd G, whose last member pair has one member
        tiles = [scan.kernel_tiles(v.shape[0])]
        if name in FORM_NAMES:
            tiles.append((ODD_G * scan.KERNEL_GROUPS, ODD_G))
        for st, g in tiles:
            form = scan.pass_a_form(q.dtype, v.dtype, fast=fast, exact=exact)
            kern = scan.pass_a(q, v, bA, bB, st=st, g=g, fast=fast,
                               exact=exact)
            torch.cuda.synchronize()
            plain = scan.pass_a_plain(q, v, bA, bB, st=st, g=g, form=form)
            worst = max(worst, compare(
                torch, f"{name} D={q.shape[1]}",
                q, v, bA, bB, st, g, form, kern, plain))
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


def check_pass_b(torch, card) -> None:
    """Pass B's tie order on the card: an arena of PASS_B_N rows, each of
    PASS_B_N / 4 SIFT-like rows repeated 4 times, so its four copies fall in
    four neighbouring groups with the same members and gmin holds runs of
    four equal values (distinct rows at equal distance). For k = 8 (a run
    ends at the last place) and 10 (the last place falls inside a run), on
    the kernel route (pass A's f32 exact form): `scan.pass_b` against a
    stable sort of the same gmin (values and positions equal: the
    reference's `lax.top_k` order), and `_scan_kernel`'s rows against
    those positions' rows."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    X = make_sift_like(PASS_B_N // 4 + KERNEL_B, DIM, seed=19)
    v = torch.from_numpy(X[:PASS_B_N // 4]).to(DEV).repeat_interleave(4, 0)
    q = torch.from_numpy(X[PASS_B_N // 4:]).to(DEV)
    bA, bB = scan.serving_bias(v, (v ** 2).sum(-1), torch.ones(
        PASS_B_N, dtype=torch.bool, device=DEV), dist.L2)
    st, g = scan.kernel_tiles(PASS_B_N)
    W = st // g
    gmin, garg = scan.pass_a(q, v, bA, bB, st=st, g=g)
    ref_d, ref_p = torch.sort(gmin, dim=1, stable=True)
    for k in (8, 10):
        bd, bp = scan.pass_b(gmin, k)
        tied = int((ref_d[:, k] == ref_d[:, k - 1]).sum())
        if not (torch.equal(bd, ref_d[:, :k])
                and torch.equal(bp, ref_p[:, :k])):
            raise AssertionError(f"pass B k={k}: not a stable sort's order")
        m = torch.gather(garg, 1, ref_p[:, :k]).long()
        want = (ref_p[:, :k] // W) * st + ref_p[:, :k] % W + m * W
        _, rows = scan._scan_kernel(q, v, bA, bB, k, exact=True)
        if not torch.equal(rows.long(), want):
            raise AssertionError(f"_scan_kernel k={k}: rows differ from "
                                 "the stable order's")
        if k == 10 and not tied:
            raise AssertionError("no run of ties across the last place: "
                                 "the check does not bite")
        print(f"phase pass B: {PASS_B_N} rows (each repeated 4x), "
              f"B={KERNEL_B}, k={k}: {tied} queries with a run of ties "
              f"across the last place; values and positions equal to a "
              f"stable sort of gmin, _scan_kernel's rows theirs [{card}]",
              flush=True)


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
            "recall": recall, "launches": launches, "eng": eng,
            "base": base, "queries": queries, "gt": gt, "gt_d": gt_d}


def exact_phase(torch, main: dict, card: str) -> dict:
    """Phase 13: phase 4's SIFT-1M scan index with scan_exact (pass A in
    the f32 exact form, 3xTF32 on the tensor cores, no re-rank), N_BATCHES
    searches of BATCH queries: recall@K against the exact oracle >=
    RECALL_MIN, the hits' distances against the oracle's
    (`check_distances`), QPS, and form 0 launched."""
    from kektordb_tpu_torch.ops import scan
    eng, queries = main["eng"], main["queries"]
    eng.configure_index("sift", {"scan_exact": True})
    eng.search("sift", queries[:BATCH], k=K)             # warm
    results, sec, counts = counted(
        torch, "Engine.search scan_exact",
        lambda: [eng.search("sift", queries[i * BATCH:(i + 1) * BATCH],
                            k=K) for i in range(N_BATCHES)],
        ("scan_pass_a",), (scan.FORM_F32,))
    for res in results:
        if len(res) != BATCH or any(len(h) != K for h in res):
            raise AssertionError("exact search returned a wrong shape")
    got = np.array([[int(x["id"][1:]) for x in h]
                    for h in results[0][:RECALL_QUERIES]])
    recall = recall_at(got, main["gt"])
    d_err = check_distances(results[0][:RECALL_QUERIES], got, main["gt_d"],
                            main["gt"], queries[:RECALL_QUERIES],
                            main["base"])
    qps = N_BATCHES * BATCH / sec
    print(f"phase exact: Engine.search scan_exact B={BATCH} k={K}, "
          f"{N_BATCHES} searches: {qps:.1f} QPS; recall@{K} {recall:.4f} on "
          f"{RECALL_QUERIES} queries (exact oracle), min {RECALL_MIN}; "
          f"distances of the shared hits max |err| {d_err:.6g} against the "
          f"oracle's, ascending; pass A form 0 launches "
          f"{counts['scan_pass_a forms'][scan.FORM_F32]} [{card}]",
          flush=True)
    if recall < RECALL_MIN:
        raise AssertionError(f"exact recall {recall} < {RECALL_MIN}")
    eng.configure_index("sift", {"scan_exact": False})   # phase 18 serves it
    return {"qps": qps, "recall": recall,
            "launches": counts["scan_pass_a forms"][scan.FORM_F32],
            "first": results[0]}


def time_pass_a(torch, card: str) -> dict:
    """Phase 5: pass A (fast form, the serving read's candidate pass) at
    the main path's shape, B=4096, N=2^20 (ST=1024, G=16): one kernel
    call held against one plain call as in phase 3, then both timed in
    turns on one card, and the product alone (`matmul_ms`); pass B on that
    output (`time_pass_b`); then the exact forms and int8 x int8
    (`time_forms`). Returns {"ms", "issue_ms", "plain_ms", "matmul_ms",
    "max_abs_err", "bound_ms", "bound_by", "pass_b", "forms"}."""
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
    del plain
    pass_b = time_pass_b(torch, card, kern[0])
    del kern

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
    bms, by = form_bound(scan, form, HEAD_B, HEAD_N, DIM, g, 4, 4)
    print(f"phase times: pass A B={HEAD_B} N={HEAD_N} D={DIM} fast form "
          f"({product(scan, form)}): kernel "
          + ", ".join(f"{t.ms:.3f}" for t in ks) + f" ms ({issue_note(ks[0])})"
          f", plain {pms:.3f} ms, torch.matmul of the product alone "
          f"{mms:.3f} ms, bound {bms:.3f} ms ({by}) [{card}]", flush=True)
    forms = time_forms(torch, card, q, v, bA, bB)
    return {"ms": kms, "issue_ms": ks[0].issue_ms, "plain_ms": pms,
            "matmul_ms": mms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": max([err] + [f["max_abs_err"]
                                        for f in forms.values()]),
            "pass_b": pass_b, "forms": forms}


def time_pass_b(torch, card, gmin) -> dict:
    """Pass B at the serving read's shape (gmin [4096, 65536], k = 32, the
    re-rank's candidates): `scan.pass_b` (topk of k + 1, the tie repair,
    the (value, position) order) held against a stable sort of the same
    gmin (equal values and positions), then timed in turns against the
    bare `torch.topk` of k it replaced, whose tie order is undefined:
    between CUDA events, and as the device time of their kernels under
    torch.profiler (pass_b waits for the card once a call, so its event
    time holds the host's turnaround). probes/pass_b_ties.py times both
    on minima where every row ties."""
    from kektordb_tpu_torch.ops import scan
    from kektordb_tpu_torch.probes.pass_b_ties import profiled_ms
    k = RERANK_C
    bd, bp = scan.pass_b(gmin, k)
    ref_d, ref_p = torch.sort(gmin, dim=1, stable=True)
    if not (torch.equal(bd, ref_d[:, :k]) and torch.equal(bp, ref_p[:, :k])):
        raise AssertionError("pass B at the serving shape differs from a "
                             "stable sort")
    del ref_d, ref_p

    def old():
        torch.topk(gmin, k, dim=1, largest=False, sorted=True)

    def new():
        scan.pass_b(gmin, k)
    olds, news = [], []
    for fn, out in ((old, olds), (new, news), (new, news), (old, olds)):
        out.append(cuda_ms(torch, fn, 5))
    dev_new, dev_old = profiled_ms(new, 5), profiled_ms(old, 5)
    print(f"phase times: pass B over gmin {list(gmin.shape)}, k={k}: "
          f"scan.pass_b (reference tie order) {dev_new:.4f} ms of device "
          "time (profiler), events "
          + ", ".join(f"{t.ms:.3f}" for t in news)
          + f" ms ({issue_note(news[0])}), against torch.topk alone (the "
          f"pass B it replaced, ties undefined) {dev_old:.4f} ms of device "
          "time, events "
          + ", ".join(f"{t.ms:.3f}" for t in olds)
          + f" ms ({issue_note(olds[0])}); equal to a stable sort [{card}]",
          flush=True)
    return {"ms": sum(t.ms for t in news) / 2, "device_ms": dev_new,
            "topk_ms": sum(t.ms for t in olds) / 2, "topk_device_ms": dev_old}


def int_mm_ms(torch, q, v):
    """Device ms of the int8 product alone, a yardstick and not the
    function: torch._int_mm of q [B, D] and the arena's rows, transposed,
    in chunks of MATMUL_CHUNK rows into one int32 output per chunk size
    (the serving shape is one _int_mm takes: B > 16, D a multiple of 8)."""
    n = v.shape[0]
    outs = {m: torch.empty((q.shape[0], m), dtype=torch.int32, device=DEV)
            for m in {min(MATMUL_CHUNK, n - i)
                      for i in range(0, n, MATMUL_CHUNK)}}

    def run():
        for i in range(0, n, MATMUL_CHUNK):
            blk = v[i:i + MATMUL_CHUNK]
            torch._int_mm(q, blk.T, out=outs[blk.shape[0]])
    return cuda_ms(torch, run, 3).ms


def hold_form(torch, card, label, q, v, biasA, biasB, st, g,
              exact, fast=False) -> dict:
    """One pass-A form at one shape: a kernel call held against the plain
    version on the same inputs as in phase 3 (`compare`; int8 x int8
    bit-equal), then kernel and plain timed in turns, beside the form's
    bound (`form_bound`: the larger of the bytes and the issued products
    at their type's rate); for int8 x int8 also torch._int_mm of the
    product alone. Returns {"form", "ms", "issue_ms", "plain_ms",
    "bound_ms", "bound_by", "max_abs_err", "matmul_ms", "shape"}."""
    from kektordb_tpu_torch.ops import scan
    form = scan.pass_a_form(q.dtype, v.dtype, fast=fast, exact=exact)
    B, N, D = q.shape[0], v.shape[0], q.shape[1]

    def kernel():
        return scan.pass_a(q, v, biasA, biasB, st=st, g=g, exact=exact,
                           fast=fast)

    def plain():
        return scan.pass_a_plain(q, v, biasA, biasB, st=st, g=g, form=form)
    kern = kernel()
    torch.cuda.synchronize()
    err = compare(torch, label, q, v, biasA, biasB, st, g, form, kern,
                  plain())
    del kern
    ks, ps = [], []
    for _ in range(2):
        ks.append(cuda_ms(torch, kernel, 3))
        ps.append(cuda_ms(torch, plain, 2).ms)
    bms, by = form_bound(scan, form, B, N, D, g, q.element_size(),
                         v.element_size())
    kms = sum(t.ms for t in ks) / 2
    mm, yard = None, ""
    if form == scan.FORM_INT8:
        mm = int_mm_ms(torch, q, v)
        yard = f", torch._int_mm of the product alone {mm:.3f} ms"
    print(f"phase times: pass A {label} B={B} N={N} D={D} (form {form}, "
          f"{product(scan, form)}): kernel "
          + ", ".join(f"{t.ms:.3f}" for t in ks)
          + f" ms ({issue_note(ks[0])}), plain {sum(ps) / 2:.3f} ms"
          f"{yard}, bound {bms:.3f} ms ({by}, "
          f"{scan.FORM_PRODUCTS[form][0]}), share {bms / kms:.3f} "
          f"[{card}]", flush=True)
    return {"form": form, "ms": kms, "issue_ms": ks[0].issue_ms,
            "plain_ms": sum(ps) / 2, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err, "matmul_ms": mm, "shape": [B, N, D]}


def time_forms(torch, card, q32, v32, bA, bB) -> dict:
    """Phase 5's exact forms and int8 x int8 at the serving shape, each
    held and timed by `hold_form`: f32 exact (form 0, 3xTF32) on the f32
    arena, int8 x int8 (form 3, s8) and the exact asymmetric form (4,
    three bf16 pieces) on its int8 codes (cosine). Returns {name:
    `hold_form`'s dict}."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import quantize as quant
    from kektordb_tpu_torch.ops import scan
    vn, qn = dist.normalize(v32), dist.normalize(q32)
    qs = quant.train(vn)
    codes, cnorms = quant.quantize(qs, vn)
    qcodes, _ = quant.quantize(qs, qn)
    live = torch.ones(HEAD_N, dtype=torch.bool, device=DEV)
    cA, cB = scan.serving_bias(codes, cnorms, live, dist.COSINE)
    st, g = scan.kernel_tiles(HEAD_N)
    return {name: hold_form(torch, card, f"{name}, serving shape", q, v,
                            biasA, biasB, st, g, exact)
            for name, q, v, biasA, biasB, exact in (
                ("f32 exact", q32, v32, bA, bB, False),
                ("int8", qcodes, codes, cA, cB, False),
                ("asym exact", qn, codes, cA, cB, True))}


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


def gather_checks(torch, v, q, ids, metric) -> list:
    """Phase 6's check-only cases beside the timed ones, from one case's
    operands: (label, v, ids, q) for int64 ids, a bf16 query on an f32
    arena, the arena one element past a 16-byte boundary (4-byte chunks for
    f32, the scalar route for bf16), one candidate per query (`descend`)
    and a ragged B, C."""
    out = [("int64 ids", v, ids.long(), q)]
    if v.dtype == torch.float32:
        out.append(("bf16 query", v, ids, q.to(torch.bfloat16)))
    flat = torch.empty(v.numel() + 1, dtype=v.dtype, device=DEV)
    odd = flat[1:].view(v.shape)
    odd.copy_(v)
    out.append(("arena one element off", odd, ids, q))
    out.append(("C=1", v, ids[:, :1].contiguous(), q))
    out.append(("B=3 C=5", v, ids[:3, :5].contiguous(), q[:3]))
    return out


def check_gather(torch, card) -> dict:
    """Phase 6. Each case of `probes.gather_cold.CASES` (the graph's three
    shapes with f32 and bf16 arenas, L2 and cosine; the TPU scripts' shape;
    200-byte and long rows) held against the plain version, then
    kernel and plain timed with cold rows (`gather_cold.cold_timing`: the
    calls rotate over enough id sets that the other sets touch 4x the L2
    between two uses of one). Returns {"max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by" (the build beam's f32 L2 case, the default
    index's hottest call), "by_case"}."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.probes import gather_cold as gc
    dev = torch.device(DEV)
    X = make_sift_like(GATHER_N + 4096, DIM, seed=13)
    v32 = torch.from_numpy(X[:GATHER_N]).to(DEV)
    q32 = torch.from_numpy(X[GATHER_N:]).to(DEV)
    sift = {
        ("f32", dist.L2): (v32, q32),
        ("bf16", dist.L2): (v32.to(torch.bfloat16), q32.to(torch.bfloat16)),
        ("f32", dist.COSINE): (dist.normalize(v32), dist.normalize(q32)),
        ("bf16", dist.COSINE): (dist.normalize(v32).to(torch.bfloat16),
                                dist.normalize(q32)),
    }
    gen = torch.Generator(device=DEV).manual_seed(15)
    worst, by_case = 0.0, {}
    for n, case in enumerate(gc.CASES):
        if (case.D, case.N) == (DIM, GATHER_N):
            metrics = (dist.L2, dist.COSINE) \
                if case.name in gc.GRAPH_SHAPES else (dist.L2,)
            arenas = {m: sift[(case.arena, m)] for m in metrics}
        else:                     # the other routes: Gaussian rows
            v = torch.randn((case.N, case.D), generator=gen, device=DEV)
            q = torch.randn((case.B, case.D), generator=gen, device=DEV)
            if case.arena == "bf16":
                v, q = v.to(torch.bfloat16), q.to(torch.bfloat16)
            arenas = {dist.L2: (v, q)}
        rb = gc.row_bytes(case.D, case.arena)
        sets = gc.id_sets(case.B, case.C, case.N, case.invalid, rb,
                          seed=100 + n, device=dev)
        for metric, (v, qa) in arenas.items():
            q = qa[:case.B]
            label = f"{case.name} {case.arena} {metric}"
            err, ratio, n_inf = hold_gather(torch, f"gather {label}", v,
                                            sets[0], q, metric)
            worst = max(worst, err)
            kt = gc.cold_timing(dev, lambda ids: dist.gathered(
                v, ids, q, metric), sets)
            pt = gc.cold_timing(dev, lambda ids: dist.gathered_plain(
                v, ids, q, metric), sets)
            bms, by = gc.bound_ms(sets, case.D, rb, q.element_size())
            by_case[label] = {"ms": kt.ms, "plain_ms": pt.ms,
                              "issue_ms": kt.issue_ms, "bound_ms": bms,
                              "bound_by": by, "share": bms / kt.ms}
            print(f"phase gather {label} B={case.B} C={case.C} D={case.D} "
                  f"N={case.N} [{dist.gather_route(v)}]: max|err| "
                  f"{err:.6g} ({ratio:.3g} of tol), +inf {n_inf}; cold rows "
                  f"over {len(sets)} id sets: kernel {kt.ms:.4f} ms "
                  f"({issue_note(kt)}), bound {bms:.4f} ms ({by}), share "
                  f"{bms / kt.ms:.3f}; plain {pt.ms:.4f} ms [{card}]",
                  flush=True)
            if n < 2 and metric == dist.L2:         # f32, bf16
                for extra, ev, eids, eq in gather_checks(torch, v, q,
                                                         sets[0], metric):
                    err, ratio, n_inf = hold_gather(
                        torch, f"gather {label}, {extra}", ev, eids, eq,
                        metric)
                    worst = max(worst, err)
                    print(f"phase gather {label}, {extra} "
                          f"[{dist.gather_route(ev)}]: max|err| "
                          f"{err:.6g} ({ratio:.3g} of tol), +inf {n_inf}",
                          flush=True)
                past = torch.full((2, 3), v.shape[0], dtype=torch.int32,
                                  device=DEV)
                if not torch.isinf(dist.gathered(v, past, q[:2],
                                                 metric)).all():
                    raise AssertionError("ids past the arena must score +inf")
    head = by_case[f"{gc.CASES[0].name} f32 {dist.L2}"]
    return {"max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "by_case": by_case}


def counted(torch, path: str, fn, need: tuple[str, ...],
            need_forms: tuple[int, ...] = ()):
    """Runs one path with every launch count set to 0 just before it and
    reads the counts just after; every kernel in `need`, and pass A in
    every form of `need_forms`, must have launched. Returns (fn's result,
    seconds, counts); counts["scan_pass_a forms"] lists pass A's launches
    by form."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan, scan_probe
    wrappers = {"gather_dist": dist.gathered, "scan_pass_a": scan.pass_a,
                "scan_vT": scan_probe.scan_vT,
                "scan_reduce": scan_probe.scan_reduce}
    for w in wrappers.values():
        w.launches = 0
    scan.pass_a.form_launches = [0] * len(scan.FORM_DTYPES)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    forms = list(scan.pass_a.form_launches)
    print(f"phase launches, {path}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + " (scan_pass_a by form: "
          + ", ".join(f"{f}: {n}" for f, n in enumerate(forms) if n)
          + ")", flush=True)
    counts["scan_pass_a forms"] = forms
    missing = [k for k in need if counts[k] < 1] \
        + [f"scan_pass_a form {f}" for f in need_forms if forms[f] < 1]
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
              for name in ("pass_a", "gather_dist")]
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
        elif e.device_type == cuda and "gather_dist" in e.key:
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
    _, build_s, build_counts = counted(
        torch, "graph build (Engine.add_batch)",
        lambda: eng.add_batch("graph", ids, base), ("gather_dist",))
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
    return {"build_s": build_s, "beam_qps": BEAM_BATCHES * BEAM_B / beam_s,
            "beam_recall": beam_recall, "scan_recall": scan_recall,
            "beam_launches": beam_counts["gather_dist"],
            "build_launches": build_counts["gather_dist"],
            "eng": eng, "base": base, "queries": queries}


def same_reads(want, got, label: str) -> int:
    """Two Engine.search results of one batch: every distance within RTOL
    of the larger (|d| + 1), and the same ids except where two adjacent
    distances of `want` tie within that tolerance. Returns how many
    positions were excused as ties."""
    excused = 0
    for b, (hw, hg) in enumerate(zip(want, got)):
        dw = np.array([h["distance"] for h in hw])
        dg = np.array([h["distance"] for h in hg])
        if dw.shape != dg.shape or np.any(
                np.abs(dw - dg) > RTOL * (np.abs(dw) + 1.0)):
            raise AssertionError(f"{label}: query {b} distances differ")
        tol = RTOL * (np.abs(dw) + 1.0)
        for j, (a, c) in enumerate(zip(hw, hg)):
            if a["id"] == c["id"]:
                continue
            near = [i for i in (j - 1, j + 1) if 0 <= i < len(dw)
                    and abs(dw[i] - dw[j]) <= tol[j]]
            if not near:
                raise AssertionError(f"{label}: query {b} place {j}: "
                                     f"{a['id']} against {c['id']}")
            excused += 1
    return excused


def persist_checks(torch, eng, want, Q, ext, allx, dead, label: str,
                   card: str) -> dict:
    """A reopened persistence engine against what its writer acknowledged:
    the B=PERSIST_B scan read (`same_reads`), every live row's vector
    bit-equal (`allx`, in the order of `ext`: the checkpoint's SIFT-like
    rows, the journaled adds, the re-added rows' new vectors), the deleted
    ids gone, the KV pairs, links, metadata patches and VCONFIG back, and
    beam recall@K >= BEAM_RECALL_MIN against the exact oracle over the
    live rows. Returns {"excused", "beam_recall", "beam_launches"}."""
    from kektordb_tpu_torch.ops import distance as dist
    idx = eng.indexes["graph"].index
    got = eng.search("graph", Q, k=K)
    excused = same_reads(want, got, label)
    gone = set(dead)
    live = [e not in gone for e in ext]
    rows = [idx.ids.get(e) for e, ok in zip(ext, live) if ok]
    if any(r is None for r in rows) or any(idx.ids.get(e) is not None
                                           for e in dead):
        raise AssertionError(f"{label}: an acknowledged add is missing, or "
                             "a deleted id is back")
    vecs = idx.state.vectors[torch.tensor(rows, device=DEV).long()]
    if not torch.equal(vecs, torch.from_numpy(allx[np.array(live)]).to(DEV)):
        raise AssertionError(f"{label}: a vector did not read back "
                             "bit-equal")
    for i in range(PERSIST_PATCHES):
        if eng.get("graph", f"g{i * 13 + 1}")["metadata"].get("tag") != i:
            raise AssertionError(f"{label}: metadata patch {i} lost")
        if eng.kv_get(f"key{i}") != f"value{i}".encode():
            raise AssertionError(f"{label}: KV pair {i} lost")
        if ("near", f"p{i}") not in {(x["relation"], x["target"]) for x in
                                     eng.get_edges("graph", f"g{i * 7 + 2}")}:
            raise AssertionError(f"{label}: link {i} lost")
    if idx.config.ef_search != PERSIST_EF:
        raise AssertionError(f"{label}: VCONFIG lost")
    gt = dist.brute_force_topk(
        torch.from_numpy(Q).to(DEV), torch.from_numpy(allx).to(DEV), K,
        valid=torch.tensor(live, device=DEV))[1].cpu().numpy()
    ext_np = np.array(ext)
    (_, brows), _, counts = counted(
        torch, f"beam on the {label} index",
        lambda: idx.search(Q, K, mode="beam"), ("gather_dist",))
    got_ext = np.array([[idx.ids.row_to_ext[r] if r >= 0 else "" for r in q]
                        for q in brows])
    rec = float(np.mean([len(set(got_ext[b]) & set(ext_np[gt[b]])) / K
                         for b in range(len(Q))]))
    print(f"phase persist: {label}: B={len(Q)} scan read as before "
          f"({excused} places excused as ties), {len(rows)} vectors "
          f"bit-equal, {len(dead)} deleted ids gone, KV / links / metadata "
          f"/ VCONFIG back; beam recall@{K} {rec:.4f} (ef_search "
          f"{idx.config.ef_search}) [{card}]", flush=True)
    if rec < BEAM_RECALL_MIN:
        raise AssertionError(f"{label}: beam recall {rec} < "
                             f"{BEAM_RECALL_MIN}")
    return {"excused": excused, "beam_recall": rec,
            "beam_launches": counts["gather_dist"]}


def order_checks(torch, eng, ctx: dict, label: str, card: str,
                 host_rows=None) -> None:
    """The journal's order cases on a reopened engine, against what the
    writer acknowledged: each re-added row's vector bit-equal to its new
    one, and found first by a search with it at a distance within float
    rounding of 0 (RTOL of the L2 terms' magnitude, 4|v|^2); each link made
    before a delete gone, each made after the re-add there, each link from
    a row deleted later gone; the dropped and re-created index holding
    exactly its new ids and vectors; the host index created empty still
    asking for the "auto" projection. With `host_rows` it gets its first
    rows here and must resolve "auto" as a fresh index does, with the
    same reads."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    idx = eng.indexes["graph"].index
    readd, X3 = ctx["readd"], ctx["X3"]
    rows = [idx.ids.get(e) for e in readd]
    if any(r is None for r in rows):
        raise AssertionError(f"{label}: a re-added id is missing")
    vecs = idx.state.vectors[torch.tensor(rows, device=DEV).long()]
    if not torch.equal(vecs, torch.from_numpy(X3).to(DEV)):
        raise AssertionError(f"{label}: a re-added row kept its old vector")
    hits = eng.search("graph", X3, k=1)
    top = [q[0]["id"] if q else None for q in hits]
    d = np.array([q[0]["distance"] if q else np.inf for q in hits])
    tol = RTOL * 4.0 * np.einsum("bd,bd->b", X3, X3)
    if top != readd or np.any(np.abs(d) > tol):
        bad = [j for j in range(len(readd)) if top[j] != readd[j]
               or abs(d[j]) > tol[j]]
        raise AssertionError(f"{label}: {len(bad)} re-added vectors not "
                             f"found first at distance 0 (e.g. "
                             f"{readd[bad[0]]}: {top[bad[0]]} at "
                             f"{d[bad[0]]})")
    for i, (src, dst) in enumerate(zip(readd, ctx["link_to"])):
        links = {(x["relation"], x["target"])
                 for x in eng.get_edges("graph", src)}
        if ("before", dst) in links or ("again", dst) not in links:
            raise AssertionError(f"{label}: {src}'s links {sorted(links)}: "
                                 "the one made before its delete is back, "
                                 "or the one after its re-add is lost")
        if eng.get_edges("graph", ctx["gone"][i]):
            raise AssertionError(f"{label}: a link from the deleted "
                                 f"{ctx['gone'][i]} is back")
    second = eng.indexes["second"].index
    ids = ctx["second_ids"]
    if len(second.ids) != len(ids) or any(second.ids.get(e) is None
                                          for e in ids):
        raise AssertionError(f"{label}: the re-created index holds "
                             f"{len(second.ids)} ids, not its "
                             f"{len(ids)} new ones")
    rows2 = torch.tensor([second.ids.get(e) for e in ids], device=DEV)
    if not torch.equal(second.state.vectors[rows2.long()],
                       torch.from_numpy(ctx["X5"]).to(DEV)):
        raise AssertionError(f"{label}: a re-created index's vector did "
                             "not read back bit-equal")
    host = eng.indexes["lazyhost"].index
    note = "still empty, its request \"auto\""
    if host_rows is None:
        if type(host).__name__ != "_LazyIndex" \
                or getattr(host, "proj_request", 0) is not None:
            raise AssertionError(f"{label}: the empty host index lost its "
                                 "\"auto\" projection request")
    else:
        fresh = Engine(EngineConfig(device=DEV, start_background=False))
        fresh.create_index("lazyhost", kind="host")
        hids = [f"h{i}" for i in range(len(host_rows))]
        for e in (eng, fresh):
            e.add_batch("lazyhost", hids, host_rows)
        host = eng.indexes["lazyhost"].index
        want = fresh.indexes["lazyhost"].index
        got_r = eng.search("lazyhost", host_rows[:64], k=K)
        want_r = fresh.search("lazyhost", host_rows[:64], k=K)
        if (host._proj_auto, host.proj_dim) != (want._proj_auto,
                                                want.proj_dim) \
                or not host._proj_auto:
            raise AssertionError(
                f"{label}: the host index resolved its projection as "
                f"(auto {host._proj_auto}, p {host.proj_dim}), a fresh one "
                f"as (auto {want._proj_auto}, p {want.proj_dim})")
        same_reads(want_r, got_r, f"{label} host index")
        note = (f"{len(hids)} first rows added, \"auto\" as a fresh "
                f"index's (p {host.proj_dim} below one chunk), the same "
                "reads")
        fresh.indexes.clear()
    print(f"phase persist: {label}: {len(readd)} re-added rows bit-equal, "
          f"each found first at |d| <= {np.abs(d).max():.4g} (tol "
          f"{tol.min():.4g}); {len(ctx['link_to'])} links "
          f"before the deletes gone, after the re-adds there; "
          f"{len(ctx['gone'])} links from deleted rows gone; the re-created "
          f"index holds its {len(ids)} new ids, bit-equal; the host index "
          f"{note} [{card}]", flush=True)


def same_frames(got, frames, corrupt, label: str) -> None:
    """The C++ scanner's frames (host_native.Frames) against the Python
    scanner's [(payload offset, length, opcode)] and corrupt offsets."""
    want = np.array(frames, np.int64).reshape(-1, 3)
    if not (np.array_equal(got.offsets, want[:, 0])
            and np.array_equal(got.lengths, want[:, 1])
            and np.array_equal(got.opcodes, want[:, 2])
            and got.corrupt.tolist() == corrupt):
        raise AssertionError(f"{label}: the C++ scanner's {len(got.offsets)}"
                             f" frames / {len(got.corrupt)} regions differ "
                             f"from the Python scanner's {len(frames)} / "
                             f"{len(corrupt)}")


def du(root: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


def persist_phase(torch, graph: dict, card: str) -> dict:
    """Phase 15 on phase 7's index (GRAPH_N SIFT-like rows, built there):
    a checkpoint of it through index_io + checkpoint, an Engine opened over
    it, PERSIST_ADDS journaled adds (a new seed, graph linked), deletes,
    metadata patches, KV sets, links and a VCONFIG; the writer's own
    thread flushes the journal, and the engine is dropped without close()
    (a crash); reopened (checkpoint + replay), closed (a checkpoint) and
    reopened again, each reopen held to the writer (`persist_checks`).
    Then compress_serving("int8") on that index: recall@K against the f32
    oracle, a checkpoint and a reopen with the same reads. All under a
    temporary directory of build/, removed at the end; a copy of the data
    dir as the first close() left it, and phase 7's queries, are phase
    21's ("serve_dir", "serve_queries")."""
    import gc as pygc
    import os
    import shutil
    import tempfile

    from kektordb_tpu_torch import host_native
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    from kektordb_tpu_torch.persist import aof, checkpoint, index_io
    X, queries = graph.pop("base"), graph.pop("queries")
    Q = queries[:PERSIST_B]
    eng0 = graph.pop("eng")
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="persist_", dir="build")
    print(f"phase persist: {shutil.disk_usage(root).free / 2**30:.1f} GiB "
          f"free under {root}", flush=True)
    ckpt_root = os.path.join(root, "checkpoints")

    def open_engine(label):
        t0 = time.perf_counter()
        eng = Engine(EngineConfig(device=DEV, data_dir=root,
                                  start_background=False)).open()
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        eng.search("graph", Q[:1], k=K)
        torch.cuda.synchronize()
        return eng, open_s, time.perf_counter() - t0

    def drop(eng):
        eng.indexes.clear()
        pygc.collect()
        torch.cuda.empty_cache()

    try:
        idx0 = eng0.indexes["graph"].index
        t0 = time.perf_counter()
        arrays = {}
        st = index_io.dump_index(idx0, "graph", arrays)
        st.update(lazy=False, language="english", memory={}, auto_links=[],
                  metadata={})
        checkpoint.save(ckpt_root, arrays, {"version": 1, "kv": {},
                                            "graph": {},
                                            "indexes": {"graph": st}})
        save_s = time.perf_counter() - t0
        ckpt_bytes = du(root)
        del arrays, idx0
        eng0.close()
        drop(eng0)
        e1, open1_s, load1_s = open_engine("checkpoint")
        print(f"phase persist: checkpoint of phase 7's {GRAPH_N} x {DIM} "
              f"index (index_io.dump_index + checkpoint.save) in "
              f"{save_s:.3f} s, {ckpt_bytes} bytes; Engine(data_dir) "
              f"open {open1_s:.3f} s, searchable after {load1_s:.3f} s "
              f"[{card}]", flush=True)

        X2 = make_sift_like(PERSIST_ADDS, DIM, seed=PERSIST_SEED)
        _, add_s, add_counts = counted(
            torch, "journaled Engine.add_batch (graph linked)",
            lambda: e1.add_batch("graph", [f"p{i}" for i in
                                           range(PERSIST_ADDS)], X2),
            ("gather_dist",))
        # the checkpoint's rows deleted, then added again with new vectors;
        # links of some made before the delete and after the re-add
        readd = [f"g{i * 997}" for i in range(PERSIST_DELETES)]
        link_to = [f"g{i * 13 + 5}" for i in range(PERSIST_LINKS)]
        X3 = make_sift_like(PERSIST_DELETES, DIM, seed=PERSIST_SEED + 1)
        X4 = make_sift_like(SECOND_N, DIM, seed=PERSIST_SEED + 2)
        X5 = make_sift_like(SECOND_N, DIM, seed=PERSIST_SEED + 3)
        second_ids = [f"n{i}" for i in range(SECOND_N)]
        for i in range(PERSIST_LINKS):
            e1.link("graph", readd[i], "before", link_to[i])
        for e in readd:
            e1.delete("graph", e)

        def order_writes():
            e1.add_batch("graph", readd, X3)
            # a second default index, dropped and created again
            e1.create_index("second")
            e1.add_batch("second", [f"d{i}" for i in range(SECOND_N)], X4)
            e1.drop_index("second")
            e1.create_index("second")
            e1.add_batch("second", second_ids, X5)
        _, order_s, order_counts = counted(
            torch, f"journaled re-adds ({PERSIST_DELETES}) and the second "
            f"index's two generations ({SECOND_N} rows each)",
            order_writes, ("gather_dist",))
        for i in range(PERSIST_LINKS):
            e1.link("graph", readd[i], "again", link_to[i])
        for i in range(PERSIST_PATCHES):
            e1.update_metadata("graph", f"g{i * 13 + 1}", {"tag": i})
            e1.kv_set(f"key{i}", f"value{i}".encode())
            e1.link("graph", f"g{i * 7 + 2}", "near", f"p{i}")
        # links from journaled rows deleted later in the journal
        dead = [f"p{PERSIST_ADDS - 1 - i}" for i in range(PERSIST_LINKS)]
        for src, dst in zip(dead, link_to):
            e1.link("graph", src, "from", dst)
        for e in dead:
            e1.delete("graph", e)
        e1.create_index("lazyhost", kind="host")
        e1.configure_index("graph", {"ef_search": PERSIST_EF})
        ctx = {"readd": readd, "X3": X3, "link_to": link_to, "gone": dead,
               "second_ids": second_ids, "X5": X5}
        ext = [f"g{i}" for i in range(GRAPH_N)] + \
            [f"p{i}" for i in range(PERSIST_ADDS)]
        allx = np.concatenate([X, X2])
        allx[[i * 997 for i in range(PERSIST_DELETES)]] = X3
        want = e1.search("graph", Q, k=K)
        time.sleep(1.5)       # past the writer's flush and fsync cadence
        if e1._aof._buf:
            raise AssertionError("the journal's own thread left frames "
                                 "unflushed after 1.5 s")
        aof_path = os.path.join(root, "journal.aof")
        aof_bytes = os.path.getsize(aof_path)
        e1._aof.close()       # flushes nothing more: a crash leaves this
        drop(e1)
        with open(aof_path, "rb") as f:
            journal = f.read()
        t0 = time.perf_counter()
        frames, corrupt = aof.scan_frames(journal)
        scan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = host_native.scan_frames(journal)
        cpp_s = time.perf_counter() - t0
        same_frames(native, frames, corrupt, "the journal")
        host_native.scan_frames.calls = 0
        # each index's bulk apply timed on its own (the class's method,
        # wrapped for this one open)
        apply_s = {}
        replay_entries = Engine._replay_entries

        def timed_entries(self, name, ops):
            t = time.perf_counter()
            replay_entries(self, name, ops)
            torch.cuda.synchronize()
            apply_s[name] = time.perf_counter() - t
        Engine._replay_entries = timed_entries
        try:
            (e2, open2_s, load2_s), _, replay_counts = counted(
                torch, "replay of the journal (checkpoint + journal open)",
                lambda: open_engine("checkpoint + journal"),
                ("gather_dist",))
        finally:
            Engine._replay_entries = replay_entries
        scanner_calls = host_native.scan_frames.calls
        replay_s = open2_s - open1_s
        graph_rows = PERSIST_ADDS - PERSIST_LINKS + PERSIST_DELETES
        replay_rows = graph_rows + SECOND_N
        ops = PERSIST_ADDS + 2 * PERSIST_DELETES + 3 * PERSIST_PATCHES + 1 \
            + 4 * PERSIST_LINKS + 2 * SECOND_N + 4
        print(f"phase persist: journaled {PERSIST_ADDS} adds (graph linked "
              f"in {add_s:.3f} s, gather_dist launches "
              f"{add_counts['gather_dist']}), {PERSIST_DELETES} deletes and "
              f"re-adds of checkpointed rows and {SECOND_N} + {SECOND_N} "
              f"rows of a dropped and re-created index ({order_s:.3f} s, "
              f"gather_dist launches {order_counts['gather_dist']}), "
              f"{PERSIST_PATCHES} metadata patches, KV sets and links, "
              f"{3 * PERSIST_LINKS} links around deletes and "
              f"{PERSIST_LINKS} deletes, an empty host index, one VCONFIG: "
              f"{len(frames)} frames, {aof_bytes} bytes, {len(corrupt)} "
              f"corrupt; crash, then Engine(data_dir) open (checkpoint + "
              f"replay) {open2_s:.3f} s, searchable after {load2_s:.3f} s; "
              f"replay {replay_s:.3f} s over the checkpoint-only open "
              f"({replay_rows} rows: {replay_rows / replay_s:.1f} rows/s, "
              f"{ops / replay_s:.1f} ops/s; the {GRAPH_N}-row index's bulk apply "
              f"{apply_s['graph']:.3f} s for {graph_rows} rows, "
              f"{graph_rows / apply_s['graph']:.1f} rows/s; the re-created "
              f"index's {apply_s.get('second', np.nan):.3f} s for "
              f"{SECOND_N} rows; C++ "
              f"scanner calls {scanner_calls}, gather_dist launches "
              f"{replay_counts['gather_dist']} against the writer's "
              f"{add_counts['gather_dist'] + order_counts['gather_dist']}) "
              f"[{card}]", flush=True)
        print(f"phase persist: frame scanners over the {aof_bytes}-byte "
              f"journal, the same {len(frames)} frames: C++ (host_native) "
              f"{cpp_s * 1e3:.3f} ms = {cpp_s / replay_s:.5f} of the "
              f"replay, Python {scan_s * 1e3:.3f} ms = "
              f"{scan_s / replay_s:.5f} of it ({scan_s / cpp_s:.1f}x) "
              f"[{card}]", flush=True)
        if len(frames) != ops or corrupt:
            raise AssertionError(f"journal: {len(frames)} frames for {ops} "
                                 f"ops, {len(corrupt)} corrupt regions")
        if scanner_calls < 1:
            raise AssertionError("the replay did not run the C++ scanner")
        # the replay links the same rows in the same chunks as their add
        if replay_counts["gather_dist"] < add_counts["gather_dist"] // 2:
            raise AssertionError(
                f"the replay launched gather_dist "
                f"{replay_counts['gather_dist']} times, the add "
                f"{add_counts['gather_dist']}")
        bad = bytearray(journal)
        bad[len(bad) // 2:len(bad) // 2 + 4096] = bytes(4096)
        del bad[-5:]                              # a torn last frame
        bad = bytes(bad)
        bad_frames, bad_corrupt = aof.scan_frames(bad)
        t0 = time.perf_counter()
        bad_native = host_native.scan_frames(bad)
        bad_s = time.perf_counter() - t0
        same_frames(bad_native, bad_frames, bad_corrupt,
                    "the corrupted journal")
        print(f"phase persist: a copy with 4096 bytes zeroed mid-journal "
              f"and a torn tail: both scanners {len(bad_frames)} frames "
              f"(of {len(frames)}), corrupt regions at "
              f"{bad_corrupt} (C++ {bad_s * 1e3:.3f} ms) [{card}]",
              flush=True)
        if len(bad_corrupt) != 2:
            raise AssertionError(f"{len(bad_corrupt)} corrupt regions in a "
                                 "journal corrupted in 2 places")
        c2 = persist_checks(torch, e2, want, Q, ext, allx, dead,
                            "checkpoint + replay", card)
        order_checks(torch, e2, ctx, "checkpoint + replay", card)
        t0 = time.perf_counter()
        e2.close()
        close_s = time.perf_counter() - t0
        drop(e2)
        disk = du(root)
        # phase 21 opens this checkpoint as the server does
        t0 = time.perf_counter()
        serve_dir = tempfile.mkdtemp(prefix="serve_", dir="build")
        shutil.copytree(root, serve_dir, dirs_exist_ok=True)
        print(f"phase persist: the closed data dir copied for phase 21 in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        e3, open3_s, load3_s = open_engine("checkpoint")
        print(f"phase persist: close() (checkpoint of "
              f"{GRAPH_N + PERSIST_ADDS - PERSIST_LINKS + SECOND_N} rows) "
              f"{close_s:.3f} s, {disk} bytes "
              f"on disk; Engine(data_dir) open (checkpoint only) "
              f"{open3_s:.3f} s, searchable after {load3_s:.3f} s [{card}]",
              flush=True)
        c3 = persist_checks(torch, e3, want, Q, ext, allx, dead,
                            "checkpoint-only reopen", card)
        order_checks(torch, e3, ctx, "checkpoint-only reopen", card,
                     host_rows=make_sift_like(HOST_LAZY_ROWS, DIM,
                                              seed=PERSIST_SEED + 4))

        idx = e3.indexes["graph"].index
        idx.compress_serving("int8")
        live = torch.ones(GRAPH_N + PERSIST_ADDS, dtype=torch.bool,
                          device=DEV)
        live[GRAPH_N + PERSIST_ADDS - PERSIST_LINKS:] = False     # `dead`
        gt = dist.brute_force_topk(torch.from_numpy(Q).to(DEV),
                                   torch.from_numpy(allx).to(DEV), K,
                                   valid=live)[1].cpu().numpy()
        wq, _, qcounts = counted(torch, "compressed int8 Engine.search",
                                 lambda: e3.search("graph", Q, k=K),
                                 ("scan_pass_a",), (scan.FORM_ASYM_FAST,))
        rec = float(np.mean([len({h["id"] for h in wq[b]}
                                 & {ext[r] for r in gt[b]}) / K
                             for b in range(len(Q))]))
        t0 = time.perf_counter()
        e3.close()
        cclose_s = time.perf_counter() - t0
        drop(e3)
        e4, open4_s, _ = open_engine("compressed")
        if not e4.indexes["graph"].index._serve_quantized:
            raise AssertionError("compressed index reopened unquantized")
        excused = same_reads(wq, e4.search("graph", Q, k=K),
                             "compressed reopen")
        print(f"phase persist: compress_serving('int8') of the reopened "
              f"index: Engine.search B={len(Q)} recall@{K} {rec:.4f} "
              f"against the f32 oracle (min {INT8_COMPRESS_RECALL_MIN}), "
              f"pass A form {scan.FORM_ASYM_FAST} launches "
              f"{qcounts['scan_pass_a forms'][scan.FORM_ASYM_FAST]}; "
              f"close() {cclose_s:.3f} s, reopen {open4_s:.3f} s: the same "
              f"ids and distances ({excused} places excused as ties) "
              f"[{card}]", flush=True)
        if rec < INT8_COMPRESS_RECALL_MIN:
            raise AssertionError(f"compressed int8 recall {rec} < "
                                 f"{INT8_COMPRESS_RECALL_MIN}")
        e4._aof.close()
        drop(e4)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"save_s": save_s, "load_s": load1_s, "replay_s": replay_s,
            "replay_rows_s": replay_rows / replay_s,
            "scan_share": scan_s / replay_s, "cpp_scan_s": cpp_s,
            "cpp_scan_share": cpp_s / replay_s, "close_s": close_s,
            "replay_launches": replay_counts["gather_dist"],
            "replay_rows": replay_rows, "graph_apply_s": apply_s["graph"],
            "order_launches": order_counts["gather_dist"],
            "load_after_close_s": load3_s, "bytes": disk,
            "add_launches": add_counts["gather_dist"],
            "beam_launches": c2["beam_launches"] + c3["beam_launches"],
            "int8_recall": rec,
            "int8_launches": qcounts["scan_pass_a"], "serve_dir": serve_dir,
            "serve_queries": queries}


def host_topk_check(torch, main: dict, card: str) -> dict:
    """The host runtime's exact top-k (host_native.bruteforce_topk, f32 on
    the host's cores) on HOST_TOPK_B of phase 4's queries over HOST_TOPK_N
    of its rows against the card's distance.brute_force_topk: each place's
    distance within RTOL of its terms' magnitudes (|q|^2 + |x|^2 +
    2|q||x|: the two sum in other orders), the same ids except where two
    adjacent distances tie within that tolerance. Both timed."""
    from kektordb_tpu_torch import host_native
    from kektordb_tpu_torch.ops import distance as dist
    q = main["queries"][:HOST_TOPK_B]
    rows = main["base"][:HOST_TOPK_N]
    t0 = time.perf_counter()
    hd, hi = host_native.bruteforce_topk(q, rows, K)
    host_s = time.perf_counter() - t0
    qt, rt = torch.from_numpy(q).to(DEV), torch.from_numpy(rows).to(DEV)
    dist.brute_force_topk(qt, rt, K)                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cd, ci = dist.brute_force_topk(qt, rt, K)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cd, ci = cd.cpu().numpy(), ci.cpu().numpy()
    q2 = np.einsum("bd,bd->b", q, q)[:, None].astype(np.float64)
    x2 = np.einsum("bkd,bkd->bk", rows[hi], rows[hi]).astype(np.float64)
    tol = RTOL * (q2 + x2 + 2.0 * np.sqrt(q2 * x2))
    err = np.abs(hd.astype(np.float64) - cd)
    if np.any(err > tol):
        raise AssertionError(f"host top-k: a distance off by {err.max()}")
    excused = 0
    for b, j in zip(*np.nonzero(hi != ci)):
        if not any(0 <= i < K and abs(hd[b, i] - hd[b, j]) <= tol[b, j]
                   for i in (j - 1, j + 1)):
            raise AssertionError(f"host top-k: query {b} place {j}: row "
                                 f"{hi[b, j]} against the card's "
                                 f"{ci[b, j]}")
        excused += 1
    print(f"phase persist: host_native.bruteforce_topk B={HOST_TOPK_B} "
          f"over {HOST_TOPK_N} x {DIM} rows, k={K}: {host_s * 1e3:.1f} ms "
          f"on the host against distance.brute_force_topk's "
          f"{card_s * 1e3:.3f} ms on the card (synchronised); the same ids "
          f"({excused} places excused as ties), distances max |err| "
          f"{err.max():.6g} [{card}]", flush=True)
    return {"host_ms": host_s * 1e3, "card_ms": card_s * 1e3,
            "excused": excused}


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
    err_a = compare(torch, f"{label} search's pass A", q, v, bA, bB, st,
                    g, form, kern, plain)
    del kern, plain
    t = cuda_ms(torch, lambda: scan.pass_a(q, v, bA, bB, st=st, g=g,
                                           fast=True), 5)
    bms, by = form_bound(scan, form, q.shape[0], v.shape[0], v.shape[1], g,
                         4, 4)
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
    """Phase 11 on phase 10's engine, which stays open for phase 21."""
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


GATHER_RANGE = "kektor::gather_dist"
# the host's calls that put work on the card, as the profiler names them
LAUNCH_CALLS = ("LaunchKernel", "Memcpy", "Memset")


def chunk_kernels(torch, idx, ext_ids, rows, card: str) -> float:
    """One build chunk of `idx` (HNSWIndex._commit) under the profiler, each
    gather-distance call inside a record_function range. Prints the
    chunk's device kernels by name (count, device ms) and, for each range,
    the host's launch calls inside it (on the range's thread, within its
    time): one each, the gather kernel, or the wrapper launched a
    conversion beside it (raises). Returns gather-distance's share of the
    chunk's device time."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile, record_function

    from kektordb_tpu_torch.ops import distance as dist
    inner = dist._gather_dist

    def marked(*args):
        with record_function(GATHER_RANGE):
            return inner(*args)
    before = dist.gathered.launches
    torch.cuda.synchronize()
    dist._gather_dist = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            idx._commit(ext_ids, rows, idx.config.ef_construction)
            torch.cuda.synchronize()
    finally:
        dist._gather_dist = inner
    launched = dist.gathered.launches - before
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict[str, list] = {}
    for e in events:
        if e.device_type == cuda:
            c = by_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us() / 1e3
    total = sum(ms for _, ms in by_name.values())
    gather_ms = sum(ms for name, (_, ms) in by_name.items()
                    if "gather_dist" in name)
    host = [e for e in events if e.device_type != cuda]
    calls = [e for e in host if any(n in e.name for n in LAUNCH_CALLS)]
    per_range = [[c.name for c in calls if c.thread == r.thread
                  and r.time_range.start <= c.time_range.start
                  and c.time_range.end <= r.time_range.end]
                 for r in host if r.name == GATHER_RANGE]
    spread = Counter(len(x) for x in per_range)
    extra = sorted({n for x in per_range if len(x) > 1 for n in x})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    share = gather_ms / total if total else float("nan")
    print(f"phase graph bf16: one build chunk under the profiler: "
          f"{sum(c for c, _ in by_name.values())} kernels, device "
          f"{total:.3f} ms; by name (count, ms): "
          + "; ".join(f"{name[:60]} ({c}, {ms:.3f})" for name, (c, ms) in top)
          + f" [{card}]", flush=True)
    print(f"phase graph bf16: gather-distance in the chunk: {launched} "
          f"calls counted, {len(per_range)} traced; host launch calls per "
          f"call: " + ", ".join(f"{k}: {v} calls" for k, v in
                                sorted(spread.items()))
          + f"; {gather_ms:.3f} ms of device time, {share:.1%} of the "
          f"chunk's [{card}]", flush=True)
    if extra:
        raise AssertionError(f"gather-distance's wrapper put more than one "
                             f"launch on the card: {extra}")
    return share


def graph_bf16_phase(torch, card: str) -> dict:
    """Phase 12: the default index at precision "bfloat16" (bf16 arena and
    bf16-encoded queries), built and served."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    X = make_sift_like(BF16_N + BATCH, DIM, seed=BF16_SEED)
    base, queries = X[:BF16_N], X[BF16_N:]
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("graph_bf16", precision="bfloat16")
    _, build_s, build_counts = counted(
        torch, "bf16 graph build (Engine.add_batch)",
        lambda: eng.add_batch("graph_bf16", [f"h{i}" for i in range(BF16_N)],
                              base), ("gather_dist",))
    idx = eng.indexes["graph_bf16"].index
    if idx.state.vectors.dtype != torch.bfloat16:
        raise AssertionError("precision bfloat16 did not give a bf16 arena")
    res, _, _ = counted(torch, "bf16 index Engine.search (scan)",
                        lambda: eng.search("graph_bf16", queries, k=K),
                        ("scan_pass_a",))
    idx.search(queries[:BEAM_B], K, mode="beam")   # warm

    def beam():
        return [idx.search(queries[i * BEAM_B:(i + 1) * BEAM_B], K,
                           mode="beam") for i in range(BEAM_BATCHES)]
    beams, beam_s, beam_counts = counted(
        torch, "bf16 index HNSWIndex.search mode='beam'", beam,
        ("gather_dist",))
    for d, _ in beams:
        if not np.isfinite(d).all() or d.shape != (BEAM_B, K):
            raise AssertionError("bf16 beam returned a wrong shape or "
                                 "non-finite distance")
    gt = dist.brute_force_topk(
        torch.from_numpy(queries[:RECALL_QUERIES]).to(DEV),
        torch.from_numpy(base).to(DEV), K)[1].cpu().numpy()
    scan_recall = recall_at(np.array([[int(x["id"][1:]) for x in h]
                                      for h in res[:RECALL_QUERIES]]), gt)
    beam_recall = recall_at(beams[0][1][:RECALL_QUERIES], gt)
    qps = BEAM_BATCHES * BEAM_B / beam_s
    print(f"phase graph bf16: Engine.create_index(precision='bfloat16'), "
          f"add_batch {BF16_N} x {DIM} built in {build_s:.3f} s "
          f"(gather_dist launches {build_counts['gather_dist']}); "
          f"Engine.search B={BATCH} (scan) recall@{K} {scan_recall:.4f}; "
          f"beam B={BEAM_B} ef_search={idx.config.ef_search}: recall@{K} "
          f"{beam_recall:.4f}, {qps:.1f} QPS (gather_dist launches "
          f"{beam_counts['gather_dist']}), against the exact oracle over "
          f"the f32 rows [{card}]", flush=True)
    if scan_recall < RECALL_MIN:
        raise AssertionError(f"bf16 scan recall {scan_recall} < {RECALL_MIN}")
    if beam_recall < BEAM_RECALL_MIN:
        raise AssertionError(f"bf16 beam recall {beam_recall} < "
                             f"{BEAM_RECALL_MIN}")
    ch = idx.config.chunk
    extra = make_sift_like(ch, DIM, seed=BF16_SEED + 1)
    share = chunk_kernels(torch, idx, [f"x{i}" for i in range(ch)], extra,
                          card)
    layout = layout_phase(torch, idx, queries, card)
    eng.close()
    return {"build_s": build_s, "beam_qps": qps, "scan_recall": scan_recall,
            "beam_recall": beam_recall, "chunk_gather_share": share,
            "build_launches": build_counts["gather_dist"],
            "beam_launches": beam_counts["gather_dist"], "layout": layout}


def layout_phase(torch, idx, queries, card: str) -> dict:
    """optimize_layout on phase 12's bf16 index (no row freed): BEAM_BATCHES
    beam batches before and after, timed; each query's ids after equal to
    its ids before on >= LAYOUT_SAME_MIN of the queries."""
    def beam(label):
        idx.search(queries[:BEAM_B], K, mode="beam")       # warm
        out, sec, counts = counted(
            torch, f"bf16 index beam, {label} optimize_layout",
            lambda: [idx.search(queries[i * BEAM_B:(i + 1) * BEAM_B], K,
                                mode="beam")[1]
                     for i in range(BEAM_BATCHES)], ("gather_dist",))
        ids = [[tuple(idx.ids.row_to_ext[r] for r in q) for q in rows]
               for rows in out]
        return ids, BEAM_BATCHES * BEAM_B / sec, counts["gather_dist"]
    before, qps0, _ = beam("before")
    t0 = time.perf_counter()
    idx.optimize_layout()
    torch.cuda.synchronize()
    lay_s = time.perf_counter() - t0
    after, qps1, launches = beam("after")
    pairs = [(a, b) for ba, bb in zip(before, after) for a, b in zip(ba, bb)]
    same = sum(a == b for a, b in pairs) / len(pairs)
    print(f"phase graph bf16: optimize_layout of {len(idx)} rows in "
          f"{lay_s:.3f} s; beam B={BEAM_B} before {qps0:.1f} QPS, after "
          f"{qps1:.1f} QPS; {same:.4f} of {len(pairs)} queries return the "
          f"same ids in the same order (min {LAYOUT_SAME_MIN}) [{card}]",
          flush=True)
    if same < LAYOUT_SAME_MIN:
        raise AssertionError(f"optimize_layout changed the beam's ids on "
                             f"{1 - same:.4f} of the queries")
    return {"s": lay_s, "qps_before": qps0, "qps_after": qps1,
            "same": same, "beam_launches": launches}


def cosine_corpus(n: int, nq: int) -> tuple[np.ndarray, np.ndarray]:
    """bench.py's cosine collection (bench.py:733-800): INT8_CENTROIDS
    Gaussian centroids, each row a centroid plus INT8_NOISE Gaussian noise,
    every row normalized, seed INT8_SEED; the queries are the draw's last
    nq rows. Returns (base [n, INT8_DIM], queries [nq, INT8_DIM])."""
    rng = np.random.default_rng(INT8_SEED)
    raw = np.empty((n + nq, INT8_DIM), np.float32)
    cents = rng.normal(size=(INT8_CENTROIDS, INT8_DIM)).astype(np.float32)
    bs = 131_072
    for i in range(0, raw.shape[0], bs):
        m = min(bs, raw.shape[0] - i)
        which = rng.integers(0, INT8_CENTROIDS, size=m)
        raw[i:i + m] = cents[which] + INT8_NOISE * rng.normal(
            size=(m, INT8_DIM)).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True) + 1e-12
    return raw[:n], raw[n:]


def int8_phase(torch, card: str) -> dict:
    """Phase 14: the reference bench's cosine / int8 collection at its own
    size, INT8_N x INT8_DIM (the MiniLM embedder's width: a RAG
    collection), in an index of precision "int8", serve_mode "scan",
    int8_symmetric (queries quantized too: the reference's max-QPS
    operating point), so every search is pass A's int8 x int8 form (s8 on
    the tensor cores). Engine.search at INT8_B, k=K: QPS; recall@K against
    the exact scan over the same int8 codes and int8 queries
    (`_scan_blocked` on the card) >= RECALL_MIN; recall@K against the f32
    cosine oracle, reported (the int8 format's own ceiling); form 3
    launched. Then form 3 held bit-equal against its plain version at this
    search's shape (the index's own 2^19-row arena) and timed beside its
    bound (`hold_form`); last, the same index with int8_symmetric off and
    scan_exact on (float queries, pass A's exact asymmetric form 4),
    recall reported, form 4 launched, and form 4 held and timed at that
    search's shape the same way (D=384: its query pieces streamed).
    Returns the search's numbers and {"int8", "asym exact"}: each form's
    `hold_form` dict at its search's shape."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    base, queries = cosine_corpus(INT8_N, 2 * INT8_B)
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("cos8", metric=dist.COSINE, precision="int8",
                     serve_mode="scan")
    eng.configure_index("cos8", {"int8_symmetric": True})
    t0 = time.perf_counter()
    eng.add_batch("cos8", [f"c{i}" for i in range(INT8_N)], base)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx = eng.indexes["cos8"].index
    if idx.state.vectors.dtype != torch.int8 or idx.ids.get("c7") != 7:
        raise AssertionError("the int8 index did not store int8 rows in "
                             "insertion order")
    Q = queries[:INT8_B]
    eng.search("cos8", Q, k=K)                             # warm

    def searches():
        return [eng.search("cos8", queries[j * INT8_B:(j + 1) * INT8_B],
                           k=K) for j in (i % 2 for i in range(INT8_BATCHES))]
    results, sec, counts = counted(torch, "int8_symmetric Engine.search",
                                   searches, ("scan_pass_a",),
                                   (scan.FORM_INT8,))
    qps = INT8_BATCHES * INT8_B / sec
    for res in results:
        if len(res) != INT8_B or any(len(h) != K for h in res):
            raise AssertionError("int8 search returned a wrong shape")
    got = np.array([[int(x["id"][1:]) for x in h] for h in results[0]])
    s = idx.state
    q8, qn8 = idx._encode_query(idx._queries(Q))
    bA, bB = scan.serving_bias(s.vectors, s.norms,
                               (s.levels >= 0) & ~s.deleted, dist.COSINE)
    exact8 = scan._scan_blocked(q8, s.vectors, bA, bB, K)[1].cpu().numpy()
    gt32 = dist.brute_force_topk(torch.from_numpy(Q).to(DEV),
                                 torch.from_numpy(base).to(DEV), K,
                                 dist.COSINE)[1].cpu().numpy()
    rec8, rec32 = recall_at(got, exact8), recall_at(got, gt32)
    print(f"phase int8: {INT8_N} x {INT8_DIM} cosine rows (bench.py's "
          f"collection, seed {INT8_SEED}), precision int8, int8_symmetric; "
          f"ingest {ingest_s:.3f} s; Engine.search B={INT8_B} k={K}: "
          f"{qps:.1f} QPS over {INT8_BATCHES} searches; recall@{K} "
          f"{rec8:.4f} against the exact scan over the same int8 codes (min "
          f"{RECALL_MIN}), {rec32:.4f} against the f32 cosine oracle "
          f"(reported); pass A form 3 launches "
          f"{counts['scan_pass_a forms'][scan.FORM_INT8]} [{card}]",
          flush=True)
    if rec8 < RECALL_MIN:
        raise AssertionError(f"int8 recall {rec8} < {RECALL_MIN} against "
                             "the exact int8 scan")

    st, g = scan.kernel_tiles(s.vectors.shape[0])
    sym = hold_form(torch, card, "int8 search's shape", q8, s.vectors, bA,
                    bB, st, g, False)

    eng.configure_index("cos8", {"int8_symmetric": False,
                                 "scan_exact": True})
    res, sec, acounts = counted(torch, "asymmetric exact Engine.search",
                                lambda: eng.search("cos8", Q, k=K),
                                ("scan_pass_a",), (scan.FORM_ASYM,))
    arec = recall_at(np.array([[int(x["id"][1:]) for x in h] for h in res]),
                     gt32)
    print(f"phase int8: the same index, int8_symmetric off, scan_exact on "
          f"(float queries x codes, pass A form 4): Engine.search B={INT8_B}"
          f" in {sec:.3f} s, recall@{K} {arec:.4f} against the f32 cosine "
          f"oracle (reported); form 4 launches "
          f"{acounts['scan_pass_a forms'][scan.FORM_ASYM]} [{card}]",
          flush=True)
    qf, _ = idx._encode_query(idx._queries(Q))
    if qf.dtype != torch.float32:
        raise AssertionError("the asymmetric search's queries are not f32")
    asym = hold_form(torch, card, "asym exact search's shape", qf,
                     s.vectors, bA, bB, st, g, True)
    eng.close()
    return {"qps": qps, "recall": rec8, "recall_f32": rec32,
            "launches": counts["scan_pass_a forms"][scan.FORM_INT8],
            "asym_launches": acounts["scan_pass_a forms"][scan.FORM_ASYM],
            "int8": sym, "asym exact": asym}


def aniso_corpus(n: int, nq: int) -> tuple[np.ndarray, np.ndarray]:
    """bench.py's anisotropic collection (bench.py:826-839): PROJ_DIM-d
    rows, a power-law spectrum (per-dimension scale (1 + j)^-0.55, so
    energy ~ (1 + j)^-1.1), 4,096 centroids plus 0.35-scaled noise, rows
    normalized, seed PROJ_SEED; the queries are the draw's last nq rows."""
    rng = np.random.default_rng(PROJ_SEED)
    scale = (1.0 + np.arange(PROJ_DIM, dtype=np.float32)) ** -0.55
    raw = np.empty((n + nq, PROJ_DIM), np.float32)
    cents = rng.normal(size=(4096, PROJ_DIM)).astype(np.float32) * scale
    bs = 131_072
    for i in range(0, raw.shape[0], bs):
        m = min(bs, raw.shape[0] - i)
        which = rng.integers(0, 4096, size=m)
        raw[i:i + m] = cents[which] + 0.35 * scale * rng.normal(
            size=(m, PROJ_DIM)).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True) + 1e-12
    return raw[:n], raw[n:]


def proj_phase(torch, card: str) -> dict:
    """Phase 16: the PCA-projected read on bench.py's anisotropic
    collection (PROJ_N x PROJ_DIM cosine rows), serve_mode "scan",
    serve_proj_dim PROJ_P, serve_proj_rerank PROJ_RERANK: Engine.search at
    PROJ_B, k=K, PROJ_BATCHES times: QPS, recall@K against the exact
    oracle (>= PROJ_RECALL_MIN), pass A's bf16 form and gather-distance
    launched; the full-dimension read of the same index (serve_proj_dim 0
    through VCONFIG) beside it. Then, at the read's own shapes: pass A's
    bf16 form over the [cap, PROJ_P] projected arena held against its plain
    version and timed (`hold_form`), and the re-rank's gather-distance
    (PROJ_RERANK candidates in full dimension) held and timed, each beside
    its bound. Returns the numbers and both kernels' dicts."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    from kektordb_tpu_torch.probes import gather_cold as gc
    base, queries = aniso_corpus(PROJ_N, 2 * PROJ_B)
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("aniso", metric=dist.COSINE, serve_mode="scan",
                     serve_proj_dim=PROJ_P, serve_proj_rerank=PROJ_RERANK)
    t0 = time.perf_counter()
    eng.add_batch("aniso", [f"a{i}" for i in range(PROJ_N)], base)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx = eng.indexes["aniso"].index
    Q = queries[:PROJ_B]
    gt = dist.brute_force_topk(torch.from_numpy(Q).to(DEV),
                               torch.from_numpy(base).to(DEV), K,
                               dist.COSINE)[1].cpu().numpy()
    t0 = time.perf_counter()
    eng.search("aniso", Q, k=K)         # fits the basis, builds the arena
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if idx._proj is None or idx._proj[0].shape != (idx._cap, PROJ_P):
        raise AssertionError("the projected arena was not built")

    def searches():
        return [eng.search("aniso", queries[j * PROJ_B:(j + 1) * PROJ_B],
                           k=K) for j in (i % 2 for i in range(PROJ_BATCHES))]

    def recall(res):
        return recall_at(np.array([[int(x["id"][1:]) for x in h]
                                   for h in res]), gt)
    res, sec, counts = counted(torch, "projected Engine.search", searches,
                               ("scan_pass_a", "gather_dist"),
                               (scan.FORM_BF16,))
    qps, rec = PROJ_BATCHES * PROJ_B / sec, recall(res[0])
    eng.configure_index("aniso", {"serve_proj_dim": 0})
    eng.search("aniso", Q, k=K)                                # warm
    fres, fsec, _ = counted(torch, "full-dimension Engine.search (same "
                            "index)", searches, ("scan_pass_a",))
    fqps, frec = PROJ_BATCHES * PROJ_B / fsec, recall(fres[0])
    print(f"phase proj: {PROJ_N} x {PROJ_DIM} cosine rows (bench.py's "
          f"anisotropic collection, seed {PROJ_SEED}), ingest "
          f"{ingest_s:.3f} s; serve_proj_dim={PROJ_P}, serve_proj_rerank="
          f"{PROJ_RERANK}: first search (basis fit + projection) "
          f"{first_s:.3f} s; Engine.search B={PROJ_B} k={K}: {qps:.1f} QPS, "
          f"recall@{K} {rec:.4f} against the exact oracle (min "
          f"{PROJ_RECALL_MIN}); the full-dimension read of the same index: "
          f"{fqps:.1f} QPS, recall@{K} {frec:.4f} [{card}]", flush=True)
    if rec < PROJ_RECALL_MIN:
        raise AssertionError(f"projected recall {rec} < {PROJ_RECALL_MIN}")
    eng.configure_index("aniso", {"serve_proj_dim": PROJ_P})
    Pa, pn = idx._proj_arena()
    q, qn = idx._encode_query(idx._queries(Q))
    qp = (q @ idx._proj_basis).to(torch.bfloat16)
    bA, bB = scan.serving_bias(Pa, pn, (idx.state.levels >= 0)
                               & ~idx.state.deleted, dist.COSINE)
    st, g = scan.kernel_tiles(Pa.shape[0])
    pa = hold_form(torch, card, f"projected read's (D={PROJ_P})", qp, Pa,
                   bA, bB, st, g, False)
    C = min(max(PROJ_RERANK, 2 * K), idx._cap // scan.g_for(idx._cap))
    _, rows = scan.scan_search(Pa, pn, idx.state.levels, idx.state.deleted,
                               None, qp, torch.zeros(PROJ_B, device=DEV), C,
                               metric=dist.COSINE, fast=True)
    v = idx.state.vectors
    err, ratio, n_inf = hold_gather(
        torch, "projected re-rank", v, rows, q, dist.COSINE,
        corpus_norms=idx.state.norms, query_norms=qn)
    kw = dict(corpus_norms=idx.state.norms, query_norms=qn)
    kt = cuda_ms(torch, lambda: dist.gathered(v, rows, q, dist.COSINE,
                                              **kw), 10)
    pt = cuda_ms(torch, lambda: dist.gathered_plain(v, rows, q,
                                                    dist.COSINE), 5)
    bms, by = gc.bound_ms([rows], PROJ_DIM, gc.row_bytes(PROJ_DIM, "f32"),
                          q.element_size())
    print(f"phase proj: re-rank gather-distance B={PROJ_B} C={C} "
          f"D={PROJ_DIM} f32 [{dist.gather_route(v)}]: max|err| {err:.6g} "
          f"({ratio:.3g} of tol), +inf {n_inf}; kernel {kt.ms:.4f} ms "
          f"({issue_note(kt)}), plain {pt.ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}), share {bms / kt.ms:.3f} [{card}]", flush=True)
    eng.close()
    return {"qps": qps, "recall": rec, "full_qps": fqps, "full_recall": frec,
            "base": base, "queries": queries, "gt": gt,
            "pass_a_launches": counts["scan_pass_a"],
            "gather_launches": counts["gather_dist"], "pass_a": pa,
            "gather": {"ms": kt.ms, "issue_ms": kt.issue_ms,
                       "plain_ms": pt.ms, "bound_ms": bms, "bound_by": by,
                       "max_abs_err": err, "shape": [PROJ_B, C, PROJ_DIM]}}


def sweep_parts(torch, idx, fn, label: str, batch_ms: float,
                card: str) -> dict:
    """Phase 17(c): one search of a host index with its sweep traced
    (`HostArenaIndex.trace`: CUDA events around each chunk's copy, scan
    and merge), beside a bare copy of the same number of bytes from pinned
    memory, the link's bound; then the same search under torch.profiler
    for the device's busy time, against the unprofiled batch (`batch_ms`)
    for its idle share (the profiler can lose kernel records after a large
    session, so the idle share by the sweep's own events, its first copy
    to its last merge, is printed beside it). Returns the parts."""
    idx.trace = True
    try:
        fn()
    finally:
        idx.trace = False
    sw = dict(idx.last_sweep)
    nbytes = sw["bytes"]
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    bare = cuda_ms(torch, lambda: dst.copy_(src, non_blocking=True), 3).ms
    del src, dst
    link_gbs = nbytes / bare / 1e6
    sweep_gbs = nbytes / sw["copy_ms"] / 1e6
    hidden = sw["copy_ms"] + sw["scan_ms"] + sw["merge_ms"] - sw["wall_ms"]
    dev, wall, top, _ = device_ms(torch, fn)
    rerank = sw.get("rerank_s")
    print(f"phase host: {label}, time by part: {sw['chunks']} chunks of "
          f"{sw['chunk_rows']} rows, {nbytes} bytes streamed; copies "
          f"{sw['copy_ms']:.3f} ms ({sweep_gbs:.2f} GB/s; a bare pinned "
          f"copy_ of the same bytes {bare:.3f} ms, {link_gbs:.2f} GB/s), "
          f"scans {sw['scan_ms']:.3f} ms ({sw['scan_ms'] / sw['chunks']:.3f}"
          f" per chunk: pass A, pass B, re-rank), merges "
          f"{sw['merge_ms']:.3f} ms; device wall {sw['wall_ms']:.3f} ms, so "
          f"{max(hidden, 0.0):.3f} ms ({max(hidden, 0.0) / sw['copy_ms']:.3f}"
          f" of the copies) ran under the scans"
          + (f"; host re-rank {rerank * 1e3:.3f} ms "
             f"({sw['rerank_bytes']} bytes gathered)" if rerank else "")
          + f"; HostArenaIndex.search {sw['search_s'] * 1e3:.3f} ms of the "
          f"Engine.search"
          + f"; the sweep's device span leaves the card idle "
          f"{1 - sw['wall_ms'] / batch_ms:.3f} of the {batch_ms:.3f} ms "
          f"batch; under the profiler: device {dev:.3f} ms in {wall:.3f} "
          f"ms, idle {1 - dev / batch_ms:.3f}; device time by op: {top} "
          f"[{card}]", flush=True)
    return {**sw, "bare_copy_ms": bare, "link_gbs": link_gbs,
            "sweep_gbs": sweep_gbs, "hidden_ms": hidden, "device_ms": dev,
            "idle": 1 - dev / batch_ms,
            "span_idle": 1 - sw["wall_ms"] / batch_ms}


def host_search(torch, eng, name, Q, B, batches, gt, label, need,
                forms, card, metric_rows=None) -> dict:
    """`batches` Engine.search calls of B queries on one host index, each
    path's launches counted (`counted`); recall@K of the first len(gt)
    queries against the exact oracle. Returns {"qps", "recall", "counts",
    "batch_ms", "res"}."""
    eng.search(name, Q[:B], k=K)                        # warm
    res, sec, counts = counted(
        torch, label, lambda: [eng.search(name, Q[(i % 2) * B:
                                                  (i % 2 + 1) * B], k=K)
                               for i in range(batches)], need, forms)
    got = np.array([[int(x["id"][1:]) for x in h]
                    for h in res[0][:len(gt)]])
    return {"qps": batches * B / sec, "recall": recall_at(got, gt),
            "counts": counts, "batch_ms": sec * 1e3 / batches, "res": res}


def host_phase(torch, main: dict, proj: dict, card: str) -> dict:
    """Phase 17: the host-RAM arena (kind="host") through the Engine on
    the card. (a) bench.py's host configuration (bench.py:952-986): every
    default, phase 4's N_BASE SIFT-like rows (the projected mirror switches
    itself on: p=32), then the same rows with serve_proj_dim=0 (the
    full-dimension sweep, recall@K >= RECALL_MIN); (b) bench.py's
    anisotropic pair (bench.py:916-950) on phase 16's collection,
    proj_dim 0 and 32 (recall >= PROJ_RECALL_MIN); (c) each read timed by
    part (`sweep_parts`); (d) launches per path, and pass A's form 1 over
    one chunk, form 5 over the projected mirror (B=BATCH and PROJ_B) and
    the sweep's gather-distance held to their plain versions and timed;
    (e) deletes and a filter on the full-dimension index, int8 and bf16
    host indexes of HOST_SPAN_N rows (recall against the exact scan of
    their stored rows >= RECALL_MIN, and against the f32 oracle); (f) a checkpoint of the default
    index under build/, reopened: the same reads, every vector bit-equal,
    the auto projection kept."""
    import gc as pygc
    import os
    import shutil
    import tempfile

    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import quantize as quant
    from kektordb_tpu_torch.ops import scan
    from kektordb_tpu_torch.persist import checkpoint
    from kektordb_tpu_torch.probes import gather_cold as gc
    base, queries, gt = main["base"], main["queries"], main["gt"]
    out: dict = {}

    # (a) the default host index, then the full-dimension sweep
    ea = Engine(EngineConfig(device=DEV, start_background=False)).open()
    ea.create_index("host", kind="host")
    t0 = time.perf_counter()
    ea.add_batch("host", [f"h{i}" for i in range(N_BASE)], base)
    ingest_s = time.perf_counter() - t0
    ha = ea.indexes["host"].index
    t0 = time.perf_counter()
    ea.search("host", queries[:BATCH], k=K)    # fits the mirror
    first_s = time.perf_counter() - t0
    if not (ha._proj_auto and ha.proj_dim == 32
            and ha._proj_vecs is not None and ha._proj_vecs.is_pinned()
            and ha._vectors.is_pinned()):
        raise AssertionError("the default host index did not switch on "
                             "its pinned projected mirror")
    auto = host_search(torch, ea, "host", queries, BATCH, HOST_BATCHES, gt,
                       "host sweep, projected (default index)",
                       ("scan_pass_a",), (scan.FORM_ASYM_FAST,), card)
    print(f"phase host: {N_BASE} x {DIM} SIFT-like rows, kind=\"host\" "
          f"with every default: ingest {ingest_s:.3f} s (pinning and "
          f"copying on growth {ha.grow_seconds:.3f} s), capacity "
          f"{ha._cap}; first search (mirror fit, p={ha.proj_dim}) "
          f"{first_s:.3f} s; Engine.search B={BATCH} k={K}: "
          f"{auto['qps']:.1f} QPS, recall@{K} {auto['recall']:.4f} on "
          f"{len(gt)} queries (phase 4's exact oracle) [{card}]",
          flush=True)
    ef = Engine(EngineConfig(device=DEV, start_background=False)).open()
    ef.create_index("full", kind="host", serve_proj_dim=0)
    t0 = time.perf_counter()
    ef.add_batch("full", [f"f{i}" for i in range(N_BASE)], base,
                 [{"grp": i % 4} for i in range(N_BASE)])
    fingest_s = time.perf_counter() - t0
    hf = ef.indexes["full"].index
    full = host_search(torch, ef, "full", queries, BATCH, HOST_BATCHES, gt,
                       "host sweep, full dimension", ("scan_pass_a",
                                                      "gather_dist"),
                       (scan.FORM_F32_FAST,), card)
    print(f"phase host: the same rows with serve_proj_dim=0 (ingest "
          f"{fingest_s:.3f} s): the full-dimension sweep, Engine.search "
          f"B={BATCH} k={K}: {full['qps']:.1f} QPS, recall@{K} "
          f"{full['recall']:.4f} (min {RECALL_MIN}) [{card}]", flush=True)
    if full["recall"] < RECALL_MIN:
        raise AssertionError(f"full-dimension host recall {full['recall']}"
                             f" < {RECALL_MIN}")
    qb = queries[:BATCH]
    out["auto"] = {**auto, "parts": sweep_parts(
        torch, ha, lambda: ea.search("host", qb, k=K),
        f"projected sweep B={BATCH}", auto["batch_ms"], card)}
    out["full"] = {**full, "parts": sweep_parts(
        torch, hf, lambda: ef.search("full", qb, k=K),
        f"full-dimension sweep B={BATCH}", full["batch_ms"], card)}

    # (d) the kernels at the sweep's shapes: form 1 over one chunk and its
    # re-rank's gather-distance (C = k); form 5 over the projected mirror
    C = hf.chunk_rows
    v = hf._vectors[:C].to(DEV)
    vn = hf._norms[:C].to(DEV)
    q = torch.from_numpy(qb).to(DEV)
    live = torch.ones(C, dtype=torch.bool, device=DEV)
    bA, bB = scan.serving_bias(v, vn, live, dist.L2)
    st, g = scan.kernel_tiles(C)
    out["form1"] = hold_form(torch, card, "host sweep chunk's (fast form)",
                             q, v, bA, bB, st, g, False, fast=True)
    _, rows = scan._scan_kernel(q, v, bA, bB, K, fast=True)
    err, ratio, n_inf = hold_gather(torch, "host sweep re-rank", v, rows, q,
                                    dist.L2, corpus_norms=vn)
    kt = cuda_ms(torch, lambda: dist.gathered(v, rows, q, dist.L2,
                                              corpus_norms=vn), 10)
    pt = cuda_ms(torch, lambda: dist.gathered_plain(v, rows, q, dist.L2), 5)
    bms, by = gc.bound_ms([rows], DIM, gc.row_bytes(DIM, "f32"),
                          q.element_size())
    print(f"phase host: the sweep's re-rank gather-distance B={BATCH} C={K} "
          f"D={DIM} f32 over one {C}-row chunk: max|err| {err:.6g} "
          f"({ratio:.3g} of tol), +inf {n_inf}; kernel {kt.ms:.4f} ms "
          f"({issue_note(kt)}), plain {pt.ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}), share {bms / kt.ms:.3f} [{card}]", flush=True)
    out["gather"] = {"ms": kt.ms, "issue_ms": kt.issue_ms,
                     "plain_ms": pt.ms, "bound_ms": bms, "bound_by": by,
                     "max_abs_err": err, "shape": [BATCH, K, DIM]}
    del v, vn, bA, bB, rows

    def hold_mirror(idx, Qm, label):
        """Form 5 over the projected mirror's first chunk as the sweep
        scans it: the projected f32 query against the int8 codes, the
        bias in the dequantized domain for L2."""
        n = min(idx._cap, C * max(1, idx.dim * 4 // idx.proj_dim))
        pv = idx._proj_vecs[:n].to(DEV)
        pn = idx._proj_norms[:n].to(DEV)
        qq = torch.from_numpy(Qm).to(DEV)
        if idx.metric == dist.COSINE:
            qq = dist.normalize(qq)
        qp = qq @ torch.from_numpy(idx._proj_basis).to(DEV)
        quantum = (idx._proj_quant.abs_max / 127.0).to(DEV) \
            if idx.metric == dist.L2 else None
        pA, pB = scan.serving_bias(
            pv, pn, torch.from_numpy(idx._valid[:n]).to(DEV), idx.metric,
            quantum)
        pst, pg = scan.kernel_tiles(n)
        return hold_form(torch, card, label, qp, pv, pA, pB, pst, pg, False)
    out["form5"] = hold_mirror(ha, qb, "host projected mirror's (D=32)")

    # (b) bench.py's anisotropic pair on phase 16's collection
    abase, aq, agt = proj["base"], proj["queries"], proj["gt"]
    ec = Engine(EngineConfig(device=DEV, start_background=False)).open()
    for name, kw in (("aniso_full", {"serve_proj_dim": 0}),
                     ("aniso_proj", {"serve_proj_dim": PROJ_P,
                                     "serve_proj_rerank": PROJ_RERANK})):
        ec.create_index(name, metric=dist.COSINE, kind="host", **kw)
        ec.add_batch(name, [f"a{i}" for i in range(PROJ_N)], abase)
    af = host_search(torch, ec, "aniso_full", aq, PROJ_B, PROJ_BATCHES, agt,
                     "host sweep, anisotropic full dimension",
                     ("scan_pass_a", "gather_dist"), (scan.FORM_F32_FAST,),
                     card)
    ap = host_search(torch, ec, "aniso_proj", aq, PROJ_B, PROJ_BATCHES, agt,
                     "host sweep, anisotropic projected p=32",
                     ("scan_pass_a",), (scan.FORM_ASYM_FAST,), card)
    hp = ec.indexes["aniso_proj"].index
    print(f"phase host: bench.py's anisotropic pair, {PROJ_N} x {PROJ_DIM} "
          f"cosine rows (phase 16's collection), Engine.search B={PROJ_B} "
          f"k={K}: proj_dim=0 {af['qps']:.1f} QPS, recall@{K} "
          f"{af['recall']:.4f}; proj_dim={hp.proj_dim} proj_rerank="
          f"{hp.proj_rerank} {ap['qps']:.1f} QPS, recall@{K} "
          f"{ap['recall']:.4f} (min {PROJ_RECALL_MIN}) [{card}]",
          flush=True)
    if ap["recall"] < PROJ_RECALL_MIN:
        raise AssertionError(f"projected host recall {ap['recall']} < "
                             f"{PROJ_RECALL_MIN}")
    aqb = aq[:PROJ_B]
    out["aniso_full"] = {**af, "parts": sweep_parts(
        torch, ec.indexes["aniso_full"].index,
        lambda: ec.search("aniso_full", aqb, k=K),
        f"anisotropic full-dimension sweep B={PROJ_B}", af["batch_ms"],
        card)}
    out["aniso_proj"] = {**ap, "parts": sweep_parts(
        torch, hp, lambda: ec.search("aniso_proj", aqb, k=K),
        f"anisotropic projected sweep B={PROJ_B}", ap["batch_ms"], card)}
    out["form5_b1024"] = hold_mirror(hp, aqb, "host anisotropic projected "
                                     "mirror's (D=32)")
    ec.close()
    del ec, hp

    # (e) deletes and a filter across the full-dimension index's chunks;
    # int8 and bf16 host indexes against the f32 oracle
    dead = [f"f{i}" for i in range(0, N_BASE, HOST_DELETE_EVERY)]
    for e in dead:
        ef.delete("full", e)
    res = ef.search("full", qb, k=K, filter="grp = 1")
    ids = [int(x["id"][1:]) for h in res for x in h]
    if len(ids) != BATCH * K or any(i % 4 != 1 for i in ids) \
            or any(i % HOST_DELETE_EVERY == 0 for i in ids):
        raise AssertionError("the filtered host sweep returned a row the "
                             "filter or a delete excludes")
    sb, sq = base[:HOST_SPAN_N], queries[:RECALL_QUERIES]
    es = Engine(EngineConfig(device=DEV, start_background=False)).open()
    span = {}
    for name, metric, prec, form in (
            ("int8", dist.COSINE, "int8", scan.FORM_INT8),
            ("bf16", dist.L2, "bfloat16", scan.FORM_BF16)):
        es.create_index(name, metric=metric, precision=prec, kind="host",
                        serve_proj_dim=0)
        es.add_batch(name, [f"s{i}" for i in range(HOST_SPAN_N)], sb)
        sgt = dist.brute_force_topk(
            torch.from_numpy(sq).to(DEV), torch.from_numpy(sb).to(DEV), K,
            metric)[1].cpu().numpy()
        span[name] = host_search(torch, es, name, queries, RECALL_QUERIES,
                                 2, sgt, f"host sweep, {prec}",
                                 ("scan_pass_a",), (form,), card)
        # the exact blocked scan over the same stored rows and the same
        # scores (the sweep's plain route, every row, no G-groups)
        si = es.indexes[name].index
        vd, nd = si._vectors.to(DEV), si._norms.to(DEV)
        q = torch.from_numpy(sq).to(DEV)
        if metric == dist.COSINE:
            q = dist.normalize(q)
        if prec == "int8":
            q = quant.quantize(si.quantizer, q)[0]
        else:
            q = q.to(vd.dtype)
        bA, bB = scan.serving_bias(vd, nd, torch.from_numpy(
            si._valid).to(DEV), metric)
        stored = scan._scan_blocked(q, vd, bA, bB, K)[1].cpu().numpy()
        got = np.array([[int(x["id"][1:]) for x in h]
                        for h in span[name]["res"][0]])
        span[name]["stored_recall"] = recall_at(got, stored)
        del vd, nd, bA, bB
        if span[name]["stored_recall"] < RECALL_MIN:
            raise AssertionError(f"{prec} host sweep against the exact "
                                 f"scan of its rows: recall "
                                 f"{span[name]['stored_recall']} < "
                                 f"{RECALL_MIN}")
    chunks = -(-HOST_SPAN_N // es.indexes["int8"].index.chunk_rows)
    print(f"phase host: {len(dead)} deletes and filter grp = 1 over the "
          f"full-dimension index's {hf._cap // hf.chunk_rows} chunks: "
          f"{len(ids)} hits, every one allowed and live; {HOST_SPAN_N} rows "
          f"({chunks} chunks), B={RECALL_QUERIES}, recall@{K} against the "
          f"exact scan of the stored rows (min {RECALL_MIN}) and against "
          f"the exact oracle over the f32 rows: int8 (cosine) "
          f"{span['int8']['stored_recall']:.4f} and "
          f"{span['int8']['recall']:.4f}; bf16 "
          f"{span['bf16']['stored_recall']:.4f} and "
          f"{span['bf16']['recall']:.4f} [{card}]", flush=True)
    out["span"] = span
    es.close()
    ef.close()
    del es, ef, hf

    # (f) the default index through a checkpoint
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="host_", dir="build")
    try:
        qr = queries[:PERSIST_B]
        want = ea.search("host", qr, k=K)
        t0 = time.perf_counter()
        arrays, state = ea._snapshot_state()
        checkpoint.save(os.path.join(root, "checkpoints"), arrays, state)
        save_s = time.perf_counter() - t0
        nbytes = du(root)
        del arrays
        t0 = time.perf_counter()
        er = Engine(EngineConfig(device=DEV, data_dir=root,
                                 start_background=False)).open()
        open_s = time.perf_counter() - t0
        hr = er.indexes["host"].index
        got = er.search("host", qr, k=K)
        excused = same_reads(want, got, "host checkpoint")
        if not (torch.equal(hr._vectors, ha._vectors)
                and torch.equal(hr._norms, ha._norms)
                and (hr._valid == ha._valid).all()):
            raise AssertionError("a host vector did not read back "
                                 "bit-equal")
        if not (hr._proj_auto and hr.proj_dim == ha.proj_dim
                and hr._vectors.is_pinned()):
            raise AssertionError("the checkpoint lost the auto projection "
                                 "or the pinned arena")
        print(f"phase host: checkpoint of the default host index "
              f"(Engine._snapshot_state + checkpoint.save) in {save_s:.3f} "
              f"s, {nbytes} bytes; Engine(data_dir) open {open_s:.3f} s; "
              f"B={PERSIST_B} read as before ({excused} places excused as "
              f"ties), {N_BASE} vectors bit-equal, the auto projection "
              f"kept (p={hr.proj_dim}) [{card}]", flush=True)
        out["ckpt"] = {"save_s": save_s, "open_s": open_s, "bytes": nbytes}
        er.close()
        del er, hr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["engine"] = ea                  # phase 21 reads it from threads
    del ha
    pygc.collect()
    torch.cuda.empty_cache()
    return out


class ServedApp:
    """`make_app(engine, **kw)` on 127.0.0.1:0, served by an event loop in
    a thread of this process; `stop` cleans the app up and joins it."""

    def __init__(self, engine, **kw):
        import asyncio
        import threading

        from aiohttp import web

        from kektordb_tpu_torch.server import make_app
        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        box = {}

        async def start():
            runner = web.AppRunner(make_app(engine, **kw))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            box["runner"] = runner
            box["port"] = site._server.sockets[0].getsockname()[1]
            started.set()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(60):
            raise AssertionError("the in-process server did not start")
        self.runner = box["runner"]
        self.base = f"http://127.0.0.1:{box['port']}"

    def stop(self):
        import asyncio
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)


def run_contracts(base: str) -> int:
    """Every step of testdata/contracts.json against a live server, as
    tests/test_contracts.py runs them; raises on the first failure.
    Returns the number of steps."""
    import base64

    import requests
    with open("testdata/contracts.json") as f:
        steps = json.load(f)["steps"]
    for step in steps:
        kw = {}
        if "body" in step:
            kw["json"] = step["body"]
        elif "raw_body" in step:
            kw["data"] = step["raw_body"].encode()
        r = requests.request(step["method"], base + step["path"], timeout=120,
                             **kw)
        sid = step["id"]
        if r.status_code != step["expect_status"]:
            raise AssertionError(f"contract {sid}: got {r.status_code}, "
                                 f"body={r.text[:200]}")
        if r.status_code == 204 or not r.content \
                or "json" not in r.headers.get("Content-Type", ""):
            continue
        data = r.json()
        if step.get("expect_type") == "array":
            if not isinstance(data, list):
                raise AssertionError(f"contract {sid}: not an array")
            continue
        bad = [f for f in step.get("expect_fields", []) if f not in data]
        bad += [k for k, v in (step.get("expect_equals") or {}).items()
                if data.get(k) != v]
        if "expect_contains_name" in step and not any(
                i.get("name") == step["expect_contains_name"] for i in data):
            bad.append("expect_contains_name")
        if step.get("expect_ids_b64_count_matches_shape"):
            flat = base64.b64decode(data["ids_b64"]).decode().split("\n")
            if len(flat) != data["shape"][0] * data["shape"][1]:
                bad.append("ids_b64 count")
        if "expect_first_id" in step \
                and data["ids"][0] != step["expect_first_id"]:
            bad.append("expect_first_id")
        if "expect_ids_subset" in step \
                and not set(data["ids"]) <= set(step["expect_ids_subset"]):
            bad.append("expect_ids_subset")
        if bad:
            raise AssertionError(f"contract {sid}: {bad}; {str(data)[:200]}")
    return len(steps)


def id_agreement(want_ids, want_d, got_ids) -> tuple[int, int]:
    """Two reads' ids, place by place: (places that differ where two
    adjacent distances of `want` tie within RTOL, places that differ
    otherwise)."""
    ties = other = 0
    for wi, wd, gi in zip(want_ids, want_d, got_ids):
        for j, (a, c) in enumerate(zip(wi, gi)):
            if a == c:
                continue
            tol = RTOL * (abs(wd[j]) + 1.0)
            if any(0 <= i < len(wd) and abs(wd[i] - wd[j]) <= tol
                   for i in (j - 1, j + 1)):
                ties += 1
            else:
                other += 1
    return ties, other


def same_ids(want_ids, want_d, got_ids, label: str) -> int:
    """Per query, the ids of an HTTP answer against Engine.search's for the
    same queries: equal, except where two adjacent distances of the
    engine's answer tie within RTOL. Returns the places excused."""
    excused = 0
    for b, (wi, wd, gi) in enumerate(zip(want_ids, want_d, got_ids)):
        if list(gi) == list(wi):
            continue
        if len(gi) != len(wi):
            raise AssertionError(f"{label}: query {b} has {len(gi)} hits")
        for j, (a, c) in enumerate(zip(wi, gi)):
            if a == c:
                continue
            tol = RTOL * (abs(wd[j]) + 1.0)
            if not any(0 <= i < len(wd) and abs(wd[i] - wd[j]) <= tol
                       for i in (j - 1, j + 1)):
                raise AssertionError(f"{label}: query {b} place {j}: "
                                     f"{c} where the engine has {a}")
            excused += 1
    return excused


def http_reads(torch, eng, base: str, queries: np.ndarray,
               card: str) -> dict:
    """Phase 18(b): phase 4's index served over HTTP at bench.py's shapes
    (bench.py:120-170): HTTP_PLAIN concurrent requests of HTTP_PLAIN_B
    queries, HTTP_COL columnar requests of HTTP_COL_B base64 queries, the
    same with wire="b64"; each answer's ids against Engine.search's for
    the same queries (`same_ids`); then HTTP_SINGLE concurrent one-query
    requests, which the QueryBatcher coalesces, and its stats. Returns
    the QPS of each and the launches of the whole run."""
    import asyncio
    import base64

    import aiohttp

    from kektordb_tpu_torch.ops import scan
    queries = np.ascontiguousarray(queries)
    url = base + "/vector/actions/search"
    plain = [{"index_name": "sift", "k": K, "query_vectors":
              queries[i * HTTP_PLAIN_B:(i + 1) * HTTP_PLAIN_B].tolist()}
             for i in range(HTTP_PLAIN)]
    cols = [queries[i * HTTP_COL_B:(i + 1) * HTTP_COL_B]
            for i in range(HTTP_COL)]
    col = [{"index_name": "sift", "k": K, "columnar": True,
            "query_vectors_b64": base64.b64encode(
                np.ascontiguousarray(c, "<f4").tobytes()).decode(),
            "query_shape": [HTTP_COL_B, DIM]} for c in cols]
    b64 = [dict(b, wire="b64") for b in col]
    single = [{"index_name": "sift", "k": K,
               "query_vector": queries[i].tolist()}
              for i in range(HTTP_SINGLE)]

    async def run():
        out = {}
        timeout = aiohttp.ClientTimeout(total=600)
        async with aiohttp.ClientSession(timeout=timeout) as sess:
            async def post(body):
                async with sess.post(url, json=body) as r:
                    o = await r.json()
                    if r.status != 200:
                        raise AssertionError(f"HTTP {r.status}: {o}")
                    return o
            for name, reqs in (("plain", plain), ("columnar", col),
                               ("b64", b64), ("single", single)):
                await post(reqs[0])                         # warm
                t0 = time.perf_counter()
                res = await asyncio.gather(*[post(b) for b in reqs])
                out[name] = (res, time.perf_counter() - t0)
            async with sess.get(base + "/system/stats") as r:
                out["stats"] = (await r.json())["batcher"]
        return out

    out, sec, counts = counted(torch, "HTTP reads of phase 4's index",
                               lambda: asyncio.run(run()),
                               ("scan_pass_a", "gather_dist"),
                               (scan.FORM_F32_FAST,))
    want = eng.search("sift", queries[:HTTP_COL * HTTP_COL_B], k=K,
                      columnar=True)
    wi, wd = want["ids"], want["distances"]
    excused = 0
    for i, o in enumerate(out["plain"][0]):
        got = [[h["id"] for h in hits] for hits in o["results_batch"]]
        lo = i * HTTP_PLAIN_B
        excused += same_ids(wi[lo:lo + HTTP_PLAIN_B],
                            wd[lo:lo + HTTP_PLAIN_B], got, "HTTP plain")
    for i, (oc, ob) in enumerate(zip(out["columnar"][0], out["b64"][0])):
        lo = i * HTTP_COL_B
        flat = base64.b64decode(ob["ids_b64"]).decode().split("\n")
        if ob["shape"] != [HTTP_COL_B, K]:
            raise AssertionError(f"b64 wire shape {ob['shape']}")
        gb = [flat[j * K:(j + 1) * K] for j in range(HTTP_COL_B)]
        for label, got in (("HTTP columnar", oc["ids"]), ("HTTP b64", gb)):
            excused += same_ids(wi[lo:lo + HTTP_COL_B],
                                wd[lo:lo + HTTP_COL_B], got, label)
    for j, o in enumerate(out["single"][0]):
        excused += same_ids(wi[j:j + 1], wd[j:j + 1],
                            [o["ids"]], "HTTP one-query")
    qps = {name: n * b / out[name][1] for name, n, b in (
        ("plain", HTTP_PLAIN, HTTP_PLAIN_B), ("columnar", HTTP_COL,
                                              HTTP_COL_B),
        ("b64", HTTP_COL, HTTP_COL_B), ("single", HTTP_SINGLE, 1))}
    print(f"phase server: phase 4's {N_BASE} x {DIM} index over HTTP: "
          f"{HTTP_PLAIN} concurrent plain requests of B={HTTP_PLAIN_B} "
          f"{qps['plain']:.1f} QPS; {HTTP_COL} columnar of B={HTTP_COL_B} "
          f"(base64 queries) {qps['columnar']:.1f} QPS; the same with "
          f"wire=\"b64\" {qps['b64']:.1f} QPS; {HTTP_SINGLE} concurrent "
          f"one-query requests {qps['single']:.1f} QPS, QueryBatcher.stats "
          f"{out['stats']}; every answer's ids those of Engine.search for "
          f"the same queries ({excused} places excused as ties) [{card}]",
          flush=True)
    return {"qps": qps, "counts": counts, "batcher": out["stats"]}


def profile_route(torch, base: str, queries: np.ndarray, card: str) -> dict:
    """Phase 18(c): POST /debug/profile?seconds=PROFILE_S while HTTP reads
    run; the task completes, and its Chrome trace holds CUDA kernel
    records, the port's kernels among them."""
    import requests
    r = requests.post(base + f"/debug/profile?seconds={PROFILE_S}",
                      timeout=60)
    if r.status_code != 202:
        raise AssertionError(f"/debug/profile: {r.status_code} {r.text}")
    task = r.json()
    t_end = time.perf_counter() + PROFILE_S
    n = 0
    while time.perf_counter() < t_end:
        requests.post(base + "/vector/actions/search", json={
            "index_name": "sift", "k": K, "columnar": True,
            "query_vectors": queries[:HTTP_PLAIN_B].tolist()}, timeout=120)
        n += 1
    deadline = time.perf_counter() + 120
    while time.perf_counter() < deadline:
        t = requests.get(base + "/system/tasks/" + task["task_id"],
                         timeout=60).json()
        if t["status"] in ("completed", "failed"):
            break
        time.sleep(0.2)
    if t["status"] != "completed":
        raise AssertionError(f"/debug/profile task: {t}")
    path = f"{task['trace_dir']}/trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = sum(1 for e in kernels if "pass_a" in e.get("name", "")
               or "gather_dist" in e.get("name", ""))
    print(f"phase server: /debug/profile?seconds={PROFILE_S} under {n} HTTP "
          f"searches: {path}, {len(events)} events, {len(kernels)} CUDA "
          f"kernel records ({ours} of the port's pass A and "
          f"gather-distance) [{card}]", flush=True)
    if not kernels or not ours:
        raise AssertionError("the /debug/profile trace holds no CUDA "
                             "kernel records of the port's kernels")
    import shutil
    shutil.rmtree(task["trace_dir"], ignore_errors=True)
    return {"events": len(events), "kernels": len(kernels), "ours": ours}


def cli_env() -> dict:
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("KEKTOR_PORT", "KEKTOR_DATA_DIR", "KEKTOR_TOKEN",
              "KEKTOR_CONFIG", "KEKTOR_COORDINATOR", "KEKTOR_PROCESS_ID",
              "KEKTOR_NUM_PROCESSES", "KEKTOR_EMBEDDER_URL"):
        env.pop(k, None)
    return env


def cli_phase(card: str) -> dict:
    """Phase 18(d): `python -m kektordb_tpu_torch serve` as a subprocess on
    the card with a data dir under build/: /healthz, create, add and
    search over HTTP, SIGTERM, a second start, every acknowledged vector
    read back bit-equal; then `python -m kektordb_tpu_torch mcp` over
    stdio: initialize, 61 tools, a vector tool call. Every process it
    starts is stopped."""
    import os
    import shutil
    import signal
    import socket
    import tempfile

    import requests
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_", dir="build")
    rng = np.random.default_rng(CLI_SEED)
    X = rng.normal(size=(CLI_N, DIM)).astype(np.float32)
    out = {}

    def start():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "kektordb_tpu_torch", "serve", "--host",
             "127.0.0.1", "--port", str(port), "--data-dir", root,
             "--device", DEV, "--log-level", "warning"], env=cli_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        base = f"http://127.0.0.1:{port}"
        while time.perf_counter() - t0 < CLI_START_S:
            if p.poll() is not None:
                raise AssertionError(f"serve exited: {p.stdout.read()}")
            try:
                if requests.get(base + "/healthz",
                                timeout=2).status_code == 200:
                    return p, base, time.perf_counter() - t0
            except requests.ConnectionError:
                time.sleep(0.25)
        p.kill()
        p.wait()
        raise AssertionError("serve did not answer /healthz")

    def stop(p):
        p.send_signal(signal.SIGTERM)
        try:
            log, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise AssertionError("serve did not stop on SIGTERM")
        if p.returncode != 0 or "Traceback" in log:
            raise AssertionError(f"serve exited {p.returncode}: {log[-2000:]}")

    procs = []
    try:
        p, base, up1 = start()
        procs.append(p)
        r = requests.post(base + "/vector/actions/create", json={
            "index_name": "cli", "metric": "euclidean"}, timeout=60)
        if r.status_code != 200:
            raise AssertionError(f"create: {r.text}")
        r = requests.post(base + "/vector/actions/add-batch", json={
            "index_name": "cli", "vectors": [
                {"id": f"c{i}", "vector": X[i].tolist()}
                for i in range(CLI_N)]}, timeout=600)
        if r.status_code != 200:
            raise AssertionError(f"add-batch: {r.text}")
        r = requests.post(base + "/vector/actions/search", json={
            "index_name": "cli", "query_vector": X[17].tolist(), "k": 1},
            timeout=60)
        if r.json().get("ids") != ["c17"]:
            raise AssertionError(f"search: {r.text}")
        stop(p)
        p, base, up2 = start()
        procs.append(p)
        r = requests.post(base + "/vector/actions/get-vectors", json={
            "index_name": "cli", "ids": [f"c{i}" for i in range(CLI_N)]},
            timeout=120)
        got = {v["id"]: v["vector"] for v in r.json()}
        back = np.array([got.get(f"c{i}", [np.nan] * DIM)
                         for i in range(CLI_N)], np.float32)
        if not np.array_equal(back, X):
            raise AssertionError("an acknowledged vector did not read back "
                                 "bit-equal after the restart")
        stop(p)
        reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
                 "params": {}},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                 "params": {"name": "save_memory",
                            "arguments": {"content": "the H100 smoke"}}},
                {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
                 "params": {"name": "list_vectors", "arguments": {}}}]
        t0 = time.perf_counter()
        m = subprocess.run(
            [sys.executable, "-m", "kektordb_tpu_torch", "mcp",
             "--device", DEV, "--log-level", "warning"], env=cli_env(),
            input="".join(json.dumps(q) + "\n" for q in reqs),
            capture_output=True, text=True, timeout=CLI_START_S)
        mcp_s = time.perf_counter() - t0
        if m.returncode != 0:
            raise AssertionError(f"mcp exited {m.returncode}: {m.stderr}")
        resp = [json.loads(line) for line in m.stdout.splitlines()]
        tools = resp[1]["result"]["tools"]
        saved = json.loads(resp[2]["result"]["content"][0]["text"])
        listed = json.loads(resp[3]["result"]["content"][0]["text"])
        if len(tools) != 61 or saved["id"] not in listed["ids"]:
            raise AssertionError(f"mcp: {len(tools)} tools, {listed}")
        print(f"phase server: `python -m kektordb_tpu_torch serve` with a "
              f"data dir: /healthz after {up1:.3f} s, {CLI_N} x {DIM} "
              f"added and searched over HTTP, SIGTERM, restarted (/healthz "
              f"after {up2:.3f} s), {CLI_N} vectors read back bit-equal; "
              f"`mcp` over stdio: {len(tools)} tools, save_memory + "
              f"list_vectors answered, {mcp_s:.3f} s in all [{card}]",
              flush=True)
        out = {"serve_up_s": [up1, up2], "mcp_s": mcp_s}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    return out


def server_phase(torch, main: dict, card: str) -> dict:
    """Phase 18: (a) make_app over an Engine on the card, with the
    gardener, on 127.0.0.1:0: every step of testdata/contracts.json;
    (b) phase 4's index over HTTP (`http_reads`); (c) /debug/profile
    (`profile_route`); (d) the CLI as a subprocess (`cli_phase`)."""
    from kektordb_tpu_torch.services.embeddings import HashingEmbedder
    from kektordb_tpu_torch.services.gardener import Gardener, GardenerConfig
    eng = main["eng"]
    gardener = Gardener(eng, config=GardenerConfig(),
                        embedder=HashingEmbedder())
    srv = ServedApp(eng, gardener=gardener)
    try:
        t0 = time.perf_counter()
        n = run_contracts(srv.base)
        print(f"phase server: make_app over Engine(device={DEV!r}) on "
              f"{srv.base}: all {n} steps of testdata/contracts.json pass "
              f"in {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        reads = http_reads(torch, eng, srv.base, main["queries"], card)
        prof = profile_route(torch, srv.base, main["queries"], card)
    finally:
        srv.stop()
    eng.close()
    del main["eng"]
    cli = cli_phase(card)
    return {"contracts": n, "reads": reads, "profile": prof, "cli": cli}


def word_hash_tokenizer(T: int):
    """Phase 19's tokenizer: [CLS] (101), each word hashed (blake2b) into
    the vocabulary past its first 1,000 ids, [SEP] (102); cut at T tokens,
    padded with 0 under a 0 mask."""
    import hashlib
    span = MINILM["vocab_size"] - 1000

    def tok(texts):
        ids = np.zeros((len(texts), T), np.int32)
        mask = np.zeros((len(texts), T), np.float32)
        for i, t in enumerate(texts):
            w = [1000 + int.from_bytes(hashlib.blake2b(
                x.encode(), digest_size=4).digest(), "little") % span
                 for x in t.split()[:T - 2]]
            w = [101] + w + [102]
            ids[i, :len(w)] = w
            mask[i, :len(w)] = 1.0
        return ids, mask
    return tok


def minilm_phase(torch, card: str) -> dict:
    """Phase 19: the MiniLM encoder at all-MiniLM-L6-v2's widths (MINILM),
    seeded random weights (`random_params`) through `from_params` with a
    word-hash tokenizer, on the card. For each (B, T) of MINILM_SHAPES and
    each pooling: MiniLMEncoder.encode timed (embeddings/s, tokenizing
    included) and the forward alone on ids already on the card (host
    clock over MINILM_REPS calls ending in a synchronize: the calls wait on
    the card, so `probes.timed` could not keep the host ahead of them);
    the embeddings finite,
    of norm 1, and the first MINILM_CHECK_ROWS held to the port's CPU
    forward on the same weights and ids within MINILM_ATOL (f32 both, TF32
    off; each row depends on its own ids only). Then MiniLMEmbedder over
    the card's encoder feeds a 384-d Engine index of MINILM_DOCS texts,
    and each of 64 texts, searched, returns its own document."""
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.services.embeddings import MiniLMEmbedder
    from kektordb_tpu_torch.services.minilm import MiniLMEncoder
    p = MiniLMEncoder.random_params(seed=MINILM_SEED, **MINILM)
    rng = np.random.default_rng(MINILM_SEED)
    out = {}
    for B, T in MINILM_SHAPES:
        lens = rng.integers(T // 2, 2 * T, size=B)
        lens[0] = 2 * T                     # one text fills the T tokens
        texts = [" ".join(f"w{x}" for x in rng.integers(0, 50_000, n))
                 for n in lens]
        tok = word_hash_tokenizer(T)
        ids, mask = tok(texts)
        for pooling in ("mean", "cls"):
            args = dict(n_layers=MINILM["n_layers"],
                        n_heads=MINILM["n_heads"], dim=MINILM["dim"],
                        pooling=pooling)
            enc = MiniLMEncoder.from_params(p, tok, device=DEV, **args)
            got = enc.encode(texts)                            # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MINILM_REPS):
                got = enc.encode(texts)
            sec = (time.perf_counter() - t0) / MINILM_REPS
            ids_d = torch.from_numpy(ids).to(DEV)
            mask_d = torch.from_numpy(mask).to(DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MINILM_REPS):
                enc(ids_d, mask_d)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3 / MINILM_REPS
            if got.shape != (B, MINILM["dim"]) \
                    or not np.isfinite(got).all():
                raise AssertionError("MiniLM: wrong shape or non-finite")
            norm_err = float(np.abs(np.linalg.norm(got, axis=1) - 1).max())
            cpu = MiniLMEncoder.from_params(p, tok, device="cpu", **args)
            n = MINILM_CHECK_ROWS
            want = cpu(ids[:n], mask[:n]).numpy()
            err = float(np.abs(got[:n] - want).max())
            print(f"phase minilm: B={B} T={T} {pooling} pooling: encode "
                  f"{sec * 1e3:.3f} ms ({B / sec:.1f} embeddings/s, "
                  f"tokenizing included), forward alone {fwd_ms:.3f} ms "
                  f"({B / fwd_ms * 1e3:.1f} embeddings/s); |norm - 1| max "
                  f"{norm_err:.3g}; "
                  f"first {n} rows against the CPU forward max|err| "
                  f"{err:.3g} (tol {MINILM_ATOL}) [{card}]", flush=True)
            if err > MINILM_ATOL or norm_err > 1e-4:
                raise AssertionError(f"MiniLM B={B} T={T} {pooling}: "
                                     f"max|err| {err}, |norm - 1| "
                                     f"{norm_err}")
            out[f"B={B} T={T} {pooling}"] = {
                "encode_per_s": B / sec, "forward_per_s": B / fwd_ms * 1e3,
                "forward_ms": fwd_ms, "max_abs_err": err}
    enc = MiniLMEncoder.from_params(
        p, word_hash_tokenizer(32), n_layers=MINILM["n_layers"],
        n_heads=MINILM["n_heads"], dim=MINILM["dim"], device=DEV)
    emb = MiniLMEmbedder.from_encoder(enc)
    docs = [f"{t} doc{i}" for i, t in
            enumerate(zipf_texts(rng, MINILM_DOCS))]
    t0 = time.perf_counter()
    vecs = np.concatenate([emb.embed_batch(docs[i:i + 256])
                           for i in range(0, MINILM_DOCS, 256)])
    embed_s = time.perf_counter() - t0
    eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
    eng.create_index("docs", metric="cosine")           # every default
    _, _, counts = counted(
        torch, "MiniLM documents into a default index",
        lambda: eng.add_batch("docs", [f"d{i}" for i in range(MINILM_DOCS)],
                              vecs, [{"content": d} for d in docs]), ())
    pick = rng.choice(MINILM_DOCS, 64, replace=False)
    hits = eng.search("docs", emb.embed_batch([docs[i] for i in pick]), k=1)
    wrong = [int(i) for i, h in zip(pick, hits) if h[0]["id"] != f"d{i}"]
    print(f"phase minilm: MiniLMEmbedder on the card embedded "
          f"{MINILM_DOCS} documents in {embed_s:.3f} s "
          f"({MINILM_DOCS / embed_s:.1f} per s, T=32) into a 384-d cosine "
          f"index; 64 texts searched, {64 - len(wrong)} returned their own "
          f"document [{card}]", flush=True)
    if wrong:
        raise AssertionError(f"MiniLM search missed documents {wrong}")
    eng.close()
    return out


def shard_scan_read(torch, eng, main: dict, exact: dict, card: str) -> dict:
    """Phase 20(a): phase 4's SIFT-1M rows in an Engine index with
    shards=SHARDS, serve_mode "scan": Engine.search at B=BATCH, N_BATCHES
    times (QPS beside phase 4's; pass A launched exactly SHARDS times a
    search), recall@K against phase 4's oracle >= RECALL_MIN; with
    scan_exact, phase 13's ids (except adjacent ties); a filtered search
    (a global-row mask) returns only allowed rows; pass A held against its
    plain version at one shard's shape and timed (`hold_form`), and the
    re-rank's gather-distance held there too."""
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    from kektordb_tpu_torch.parallel import ShardedHNSW
    base, queries = main["base"], main["queries"]
    eng.create_index("sift4", metric=dist.L2, serve_mode="scan",
                     shards=SHARDS)
    t0 = time.perf_counter()
    eng.add_batch("sift4", [f"v{i}" for i in range(N_BASE)], base)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx = eng.indexes["sift4"].index
    sizes = [len(s) for s in idx.shards]
    if not isinstance(idx, ShardedHNSW) or sum(sizes) != N_BASE \
            or min(s._cap for s in idx.shards) < scan.PALLAS_MIN_ROWS:
        raise AssertionError(f"sharded index: {type(idx)} {sizes}")
    eng.search("sift4", queries[:BATCH], k=K)              # warm
    results, sec, counts = counted(
        torch, f"sharded Engine.search (S={SHARDS})",
        lambda: [eng.search("sift4", queries[i * BATCH:(i + 1) * BATCH],
                            k=K) for i in range(N_BATCHES)],
        ("scan_pass_a", "gather_dist"), (scan.FORM_F32_FAST,))
    if counts["scan_pass_a"] != SHARDS * N_BATCHES:
        raise AssertionError(f"pass A launched {counts['scan_pass_a']} "
                             f"times in {N_BATCHES} searches of {SHARDS} "
                             "shards")
    qps = N_BATCHES * BATCH / sec
    got = np.array([[int(x["id"][1:]) for x in h]
                    for h in results[0][:RECALL_QUERIES]])
    recall = recall_at(got, main["gt"])
    d_err = check_distances(results[0][:RECALL_QUERIES], got, main["gt_d"],
                            main["gt"], queries[:RECALL_QUERIES], base)
    print(f"phase shards: {N_BASE} x {DIM} over {SHARDS} shards of "
          f"{sizes} rows (one card, the device-repeat setting), ingest "
          f"{ingest_s:.3f} s; Engine.search B={BATCH} k={K}: {qps:.1f} QPS "
          f"(phase 4, one index: {main['qps']:.1f}); recall@{K} "
          f"{recall:.4f} against phase 4's oracle (min {RECALL_MIN}); "
          f"distances max |err| {d_err:.6g}; pass A "
          f"{counts['scan_pass_a'] / N_BATCHES:.0f} launches a search "
          f"[{card}]", flush=True)
    if recall < RECALL_MIN:
        raise AssertionError(f"sharded recall {recall} < {RECALL_MIN}")

    eng.configure_index("sift4", {"scan_exact": True})
    res_x, _, cx = counted(torch, "sharded Engine.search scan_exact",
                           lambda: eng.search("sift4", queries[:BATCH], k=K),
                           ("scan_pass_a",), (scan.FORM_F32,))
    want = exact["first"]
    ties, other = id_agreement([[h["id"] for h in q] for q in want],
                               [[h["distance"] for h in q] for q in want],
                               [[h["id"] for h in q] for q in res_x])
    xgot = np.array([[int(x["id"][1:]) for x in h]
                     for h in res_x[:RECALL_QUERIES]])
    xrec = recall_at(xgot, main["gt"])
    eng.configure_index("sift4", {"scan_exact": False})
    print(f"phase shards: scan_exact B={BATCH}: against phase 13's ids (one "
          f"index), {ties} places differ as adjacent ties, {other} of "
          f"{BATCH * K} otherwise (max {1 - RECALL_MIN:.2f} of them: pass "
          f"A's group collisions fall on other rows in a 2^18-row shard "
          f"than in the 2^20-row arena); recall@{K} {xrec:.4f} against the "
          f"oracle; form 0 launches "
          f"{cx['scan_pass_a forms'][scan.FORM_F32]} [{card}]", flush=True)
    if other > (1 - RECALL_MIN) * BATCH * K or xrec < RECALL_MIN:
        raise AssertionError(f"sharded scan_exact: {other} places differ "
                             f"from phase 13's, recall {xrec}")
    excused = ties

    allow = np.zeros(idx._cap, bool)
    allow[idx.ids.rows_of([f"v{i}" for i in range(0, N_BASE, 100)])] = True
    _, g = idx.search(queries[:64], K, allow_rows=allow)
    exts = idx.ids.exts_array()[g[g >= 0]]
    if g.min() < 0 or any(int(e[1:]) % 100 for e in exts):
        raise AssertionError("the sharded filtered search broke its filter")
    print(f"phase shards: filtered search (every 100th row allowed): "
          f"{exts.size} hits, all allowed", flush=True)

    sh0 = idx.shards[0]
    q, qn, bA, bB, st, gg = path_operands(torch, sh0, queries[:BATCH])
    held = hold_form(torch, card, f"sharded scan, one shard's shape",
                     q, sh0.state.vectors, bA, bB, st, gg, False, fast=True)
    _, rows = scan._scan_kernel(q, sh0.state.vectors, bA, bB, RERANK_C,
                                fast=True)
    err_g, ratio, _ = hold_gather(torch, "sharded re-rank",
                                  sh0.state.vectors, rows, q, dist.L2,
                                  corpus_norms=sh0.state.norms,
                                  query_norms=qn)
    print(f"phase shards: the re-rank's gather-distance at one shard's shape "
          f"(B={BATCH}, C={rows.shape[1]}) against its plain version: "
          f"max|err| {err_g:.6g} ({ratio:.3g} of tol)", flush=True)
    return {"qps": qps, "recall": recall, "launches": counts["scan_pass_a"],
            "gather_launches": counts["gather_dist"], "excused": excused,
            "held": held, "gather_err": err_g, "ingest_s": ingest_s}


def shard_more_reads(torch, eng, main: dict, card: str) -> dict:
    """Phase 20(b): a sharded default (graph) index of SHARD_GRAPH_N
    rows (ShardedHNSW, every HNSWConfig default), its build's
    gather-distance launches per chunk, and its beam (B=BEAM_B,
    ef_search 100) recall@K against the exact oracle over those rows, no
    more than SHARD_BEAM_SLACK below one HNSWIndex's over the same rows
    (100k of the generator's 1M rows leave its clusters sparse: the beam
    of one index reaches 0.92 there, where the 1M index passes 0.95); the
    projected scan on (a)'s index (serve_proj_dim
    PROJ_P, rerank PROJ_RERANK, one basis for every shard: pass A's bf16
    form once per shard and search) recall@K >= PROJ_RECALL_MIN; an int8
    cosine index (int8_symmetric) of the same 1M rows over SHARDS shards,
    one quantizer shared by all (form 3 once per shard and search),
    recall@K >= RECALL_MIN against the exact scan over the same codes."""
    from kektordb_tpu_torch.index import HNSWConfig, HNSWIndex
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.ops import scan
    from kektordb_tpu_torch.parallel import ShardedHNSW, make_mesh
    base, queries = main["base"], main["queries"]
    out = {}
    gi = ShardedHNSW(DIM, dist.L2, config=HNSWConfig(),
                     mesh=make_mesh(SHARDS, DEV))
    ext = [f"v{i}" for i in range(SHARD_GRAPH_N)]
    _, build_s, bc = counted(
        torch, f"sharded graph build ({SHARDS} x "
               f"{SHARD_GRAPH_N // SHARDS})",
        lambda: gi.add_batch(ext, base[:SHARD_GRAPH_N]), ("gather_dist",))
    chunks = sum(-(-len(s) // gi.config.chunk) for s in gi.shards)
    Qb = queries[:BEAM_B]
    gt = dist.brute_force_topk(torch.from_numpy(Qb).to(DEV),
                               torch.from_numpy(base[:SHARD_GRAPH_N]).to(DEV),
                               K)[1].cpu().numpy()
    gi.search(Qb, K, mode="beam")                              # warm
    (_, g), beam_s, cb = counted(torch, "sharded beam",
                                 lambda: gi.search(Qb, K, mode="beam"),
                                 ("gather_dist",))
    got = np.array([[int(e[1:]) for e in gi.ids.exts_array()[row]]
                    for row in g])
    rb = recall_at(got, gt)
    del gi
    one = HNSWIndex(DIM, dist.L2, config=HNSWConfig(), device=DEV)
    t0 = time.perf_counter()
    one.add_batch(ext, base[:SHARD_GRAPH_N])
    one_s = time.perf_counter() - t0
    _, r1 = one.search(Qb, K, mode="beam")
    r1 = recall_at(np.array([[int(one.ids.row_to_ext[r][1:]) for r in row]
                             for row in r1]), gt)
    del one
    print(f"phase shards: graph index {SHARDS} x {SHARD_GRAPH_N // SHARDS} "
          f"(every default) built in {build_s:.3f} s, gather-distance "
          f"{bc['gather_dist']} launches over {chunks} chunks "
          f"({bc['gather_dist'] / chunks:.1f} a chunk); beam B={BEAM_B} "
          f"ef_search 100: {BEAM_B / beam_s:.1f} QPS, recall@{K} {rb:.4f}, "
          f"gather-distance {cb['gather_dist']} launches; one index over "
          f"the same rows (built in {one_s:.3f} s): beam recall@{K} "
          f"{r1:.4f}, the sharded read's floor less {SHARD_BEAM_SLACK} "
          f"[{card}]", flush=True)
    if rb < r1 - SHARD_BEAM_SLACK:
        raise AssertionError(f"sharded beam recall {rb} < the one index's "
                             f"{r1} - {SHARD_BEAM_SLACK}")
    out.update(build_s=build_s, build_launches=bc["gather_dist"],
               chunks=chunks, beam_recall=rb, beam_qps=BEAM_B / beam_s,
               beam_launches=cb["gather_dist"], one_beam_recall=r1)

    eng.configure_index("sift4", {"serve_proj_dim": PROJ_P,
                                  "serve_proj_rerank": PROJ_RERANK})
    eng.search("sift4", queries[:BATCH], k=K)          # fit and project
    idx = eng.indexes["sift4"].index
    basis = idx.shards[0]._proj_basis
    if any(not torch.equal(s._proj_basis, basis) for s in idx.shards):
        raise AssertionError("the shards' projection bases differ")
    res, sec, cp = counted(
        torch, "sharded projected Engine.search",
        lambda: [eng.search("sift4", queries[i * BATCH:(i + 1) * BATCH],
                            k=K) for i in range(2)],
        ("scan_pass_a", "gather_dist"), (scan.FORM_BF16,))
    if cp["scan_pass_a"] != SHARDS * 2:
        raise AssertionError(f"projected: pass A launched "
                             f"{cp['scan_pass_a']} times in 2 searches")
    rp = recall_at(np.array([[int(x["id"][1:]) for x in h]
                             for h in res[0][:RECALL_QUERIES]]), main["gt"])
    eng.configure_index("sift4", {"serve_proj_dim": 0})
    print(f"phase shards: projected scan (p={PROJ_P}, rerank {PROJ_RERANK}, "
          f"one basis for the {SHARDS} shards) B={BATCH}: "
          f"{2 * BATCH / sec:.1f} QPS, recall@{K} {rp:.4f} (min "
          f"{PROJ_RECALL_MIN}); pass A form 2 "
          f"{cp['scan_pass_a forms'][scan.FORM_BF16]} launches [{card}]",
          flush=True)
    if rp < PROJ_RECALL_MIN:
        raise AssertionError(f"sharded projected recall {rp} < "
                             f"{PROJ_RECALL_MIN}")
    out.update(proj_recall=rp, proj_qps=2 * BATCH / sec,
               proj_launches=cp["scan_pass_a"])

    eng.create_index("cos4", metric=dist.COSINE, precision="int8",
                     serve_mode="scan", shards=SHARDS)
    eng.configure_index("cos4", {"int8_symmetric": True})
    eng.add_batch("cos4", [f"v{i}" for i in range(N_BASE)], base)
    c8 = eng.indexes["cos4"].index
    scales = {float(s.quantizer.abs_max) for s in c8.shards}
    if len(scales) != 1:
        raise AssertionError(f"int8 shards hold {len(scales)} quantizers")
    Q = queries[:INT8_B]
    eng.search("cos4", Q, k=K)                                 # warm
    res, sec, c3 = counted(torch, "sharded int8_symmetric Engine.search",
                           lambda: [eng.search("cos4", Q, k=K)
                                    for _ in range(2)],
                           ("scan_pass_a",), (scan.FORM_INT8,))
    if c3["scan_pass_a forms"][scan.FORM_INT8] != SHARDS * 2:
        raise AssertionError("int8: form 3 did not run once per shard")
    # the exact scan over every shard's codes, as one arena
    codes = torch.cat([s.state.vectors[:s.ids.capacity_used]
                       for s in c8.shards])
    cn = torch.cat([s.state.norms[:s.ids.capacity_used] for s in c8.shards])
    row_ext = np.concatenate([np.array(s.ids.row_to_ext, dtype=object)
                              for s in c8.shards])
    q8, _ = c8.shards[0]._encode_query(c8.shards[0]._queries(Q))
    bA, bB = scan.serving_bias(
        codes, cn, torch.ones(codes.shape[0], dtype=torch.bool, device=DEV),
        dist.COSINE)
    ex = scan._scan_blocked(q8, codes, bA, bB, K)[1].cpu().numpy()
    want = np.array([[int(e[1:]) for e in row_ext[r]] for r in ex])
    got = np.array([[int(x["id"][1:]) for x in h] for h in res[0]])
    r8 = recall_at(got, want)
    print(f"phase shards: int8 cosine index of {N_BASE} rows over {SHARDS} "
          f"shards, one quantizer (abs_max {scales.pop():.6g}), "
          f"int8_symmetric B={INT8_B}: {2 * INT8_B / sec:.1f} QPS, "
          f"recall@{K} {r8:.4f} against the exact scan over the same codes "
          f"(min {RECALL_MIN}); form 3 "
          f"{c3['scan_pass_a forms'][scan.FORM_INT8]} launches [{card}]",
          flush=True)
    if r8 < RECALL_MIN:
        raise AssertionError(f"sharded int8 recall {r8} < {RECALL_MIN}")
    eng.drop_index("cos4")
    out.update(int8_recall=r8, int8_qps=2 * INT8_B / sec,
               int8_launches=c3["scan_pass_a forms"][scan.FORM_INT8])
    return out


def shard_engine_persist(torch, card: str) -> dict:
    """Phase 20(c): the Engine with shards=SHARDS and a data dir under
    build/: create (every default: graph on insert), add SHARD_ENGINE_N
    SIFT-like rows with Zipf texts, a hybrid search (text_query, alpha 0.5
    and 1: each query's own row first at alpha 1), 100 deletes, a
    checkpoint and a reopen that comes back sharded, the same hybrid ids
    (except adjacent ties), every vector bit-equal, the deleted ids gone."""
    import shutil
    import tempfile

    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.parallel import ShardedHNSW
    X = make_sift_like(SHARD_ENGINE_N, DIM, seed=SHARD_ENGINE_SEED)
    rng = np.random.default_rng(SHARD_ENGINE_SEED)
    texts = zipf_texts(rng, SHARD_ENGINE_N)
    root = tempfile.mkdtemp(prefix="shards_", dir="build")
    try:
        e = Engine(EngineConfig(device=DEV, data_dir=root,
                                start_background=False)).open()
        e.create_index("docs4", shards=SHARDS)
        t0 = time.perf_counter()
        e.add_batch("docs4", [f"c{i}" for i in range(SHARD_ENGINE_N)], X,
                    [{"body": t, "_indexed_fields": ["body"]}
                     for t in texts])
        add_s = time.perf_counter() - t0
        Q = X[100:164]
        self_hits = e.search("docs4", Q, k=K, text_query=TEXT_QUERY,
                             alpha=1.0)
        if any(h[0]["id"] != f"c{100 + b}" for b, h in enumerate(self_hits)):
            raise AssertionError("sharded hybrid alpha=1: a query missed "
                                 "its own row")
        dead = [f"c{i}" for i in range(100)]
        for d in dead:
            e.delete("docs4", d)
        want = e.search("docs4", Q, k=K, text_query=TEXT_QUERY, alpha=0.5)
        e.close()                                  # writes a checkpoint
        t0 = time.perf_counter()
        e2 = Engine(EngineConfig(device=DEV, data_dir=root,
                                 start_background=False)).open()
        open_s = time.perf_counter() - t0
        idx = e2.indexes["docs4"].index
        if not isinstance(idx, ShardedHNSW) or idx.n_shards != SHARDS \
                or len(idx) != SHARD_ENGINE_N - len(dead):
            raise AssertionError("the reopened index is not the sharded one")
        got = e2.search("docs4", Q, k=K, text_query=TEXT_QUERY, alpha=0.5)
        excused = same_ids([[h["id"] for h in q] for q in want],
                           [[h["score"] for h in q] for q in want],
                           [[h["id"] for h in q] for q in got],
                           "reopened sharded hybrid")
        n_eq = 0
        for s in idx.shards:
            exts = [x for x in s.ids.ext_to_row]
            rows = torch.tensor([s.ids.ext_to_row[x] for x in exts],
                                device=DEV).long()
            want_v = torch.from_numpy(X[[int(x[1:]) for x in exts]]).to(DEV)
            if not torch.equal(s.state.vectors[rows], want_v):
                raise AssertionError("a sharded vector did not read back "
                                     "bit-equal")
            n_eq += len(exts)
        if any(idx.ids.get(d) is not None for d in dead):
            raise AssertionError("a deleted id came back")
        e2.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase shards: Engine shards={SHARDS}, {SHARD_ENGINE_N} rows "
          f"with text (graph on insert) added in {add_s:.3f} s; hybrid "
          f"alpha=1 returns each query's row; {len(dead)} deletes; "
          f"checkpoint and reopen ({open_s:.3f} s) came back sharded, the "
          f"hybrid ids as before ({excused} places excused as ties), "
          f"{n_eq} vectors bit-equal [{card}]", flush=True)
    return {"add_s": add_s, "open_s": open_s, "excused": excused}


_REPLICA_CHILD = '''
import json, sys, time
import numpy as np
import torch
pid, nproc, coord, data, out, dev = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5],
                                     sys.argv[6])
from kektordb_tpu_torch.distboot import init_distributed
init_distributed(coord, num_processes=nproc, process_id=pid, device=dev,
                 timeout_s=240)
import torch.distributed as tdist
from kektordb_tpu_torch.index import HNSWConfig
from kektordb_tpu_torch.ops import distance as dist
from kektordb_tpu_torch.ops import scan
from kektordb_tpu_torch.parallel import ShardedHNSW
from kektordb_tpu_torch.parallel import distributed as dlib
z = np.load(data)
X, Q, reps, k = z["X"], z["Q"], int(z["reps"]), int(z["k"])
mesh2d = dlib.replica_mesh(device=dev)
sh = ShardedHNSW(X.shape[1], "euclidean",
                 config=HNSWConfig(serve_mode="scan"),
                 mesh=dlib.local_shard_mesh(mesh2d))
sh.add_batch([f"v{i}" for i in range(X.shape[0])], X)
rep = dlib.ReplicatedServing(sh, mesh2d)
rep.search(Q, k)
scan.pass_a.launches = 0
dist.gathered.launches = 0
t0 = time.perf_counter()
for _ in range(reps):
    d, g = rep.search(Q, k)
sec = time.perf_counter() - t0
launches = (scan.pass_a.launches, dist.gathered.launches)
vr = rep.verify_replicas()
json.dump({"rank": pid, "backend": tdist.get_backend(),
           "devices": [str(x) for x in sh.mesh], "qps": reps * len(Q) / sec,
           "pass_a": launches[0], "gather": launches[1],
           "equal": vr["equal"], "crc": vr["fingerprint_crc32"],
           "ids": sh.ids.exts_array()[g].tolist(), "d": d.tolist()},
          open(out, "w"))
tdist.destroy_process_group()
'''


def replica_phase(torch, main: dict, card: str) -> dict:
    """Phase 20(d): two processes on the card form a torch.distributed
    group (distboot's rule: two ranks, one card -> gloo, the tops staged
    through the host), each a full replica of REPLICA_SHARDS shards of
    REPLICA_N of phase 4's rows; ReplicatedServing.search of BATCH
    queries (each rank scans its half), REPLICA_SEARCHES times: QPS, each
    rank's pass-A launches (REPLICA_SHARDS a search), the gathered ids
    equal (except adjacent ties) to this process's single-process sharded
    search of the same rows, and verify_replicas equal on both. Each child
    has CHILD_TIMEOUT_S; a child's failure or timeout fails the phase."""
    import os
    import shutil
    import socket
    import tempfile

    from kektordb_tpu_torch import device as devlib
    from kektordb_tpu_torch.index import HNSWConfig
    from kektordb_tpu_torch.ops import distance as dist
    from kektordb_tpu_torch.parallel import ShardedHNSW
    X, Q = main["base"][:REPLICA_N], main["queries"][:BATCH]
    root = tempfile.mkdtemp(prefix="replicas_", dir="build")
    procs = []
    try:
        data = os.path.join(root, "rows.npz")
        np.savez(data, X=X, Q=Q, reps=REPLICA_SEARCHES, k=K)
        child = os.path.join(root, "replica.py")
        with open(child, "w") as f:
            f.write(_REPLICA_CHILD)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            coord = f"localhost:{s.getsockname()[1]}"
        env = cli_env()
        env[devlib.DEVICE_REPEAT_ENV] = str(REPLICA_SHARDS)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, child, str(r), str(REPLICAS), coord, data,
             os.path.join(root, f"out{r}.json"), DEV], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(REPLICAS)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError("a replica process timed out")
        wall = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"replica {r} failed "
                                     f"({p.returncode}):\n{log[-3000:]}")
        outs = [json.load(open(os.path.join(root, f"out{r}.json")))
                for r in range(REPLICAS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    sh = ShardedHNSW(DIM, dist.L2, config=HNSWConfig(serve_mode="scan"),
                     mesh=devlib.visible_devices(DEV)[:1] * REPLICA_SHARDS)
    sh.add_batch([f"v{i}" for i in range(REPLICA_N)], X)
    d, g = sh.search(Q, K)
    want = sh.ids.exts_array()[g].tolist()
    excused = []
    for o in outs:
        if o["backend"] != "gloo" or not o["equal"]:
            raise AssertionError(f"replica {o['rank']}: backend "
                                 f"{o['backend']}, replicas equal "
                                 f"{o['equal']}")
        if o["pass_a"] != REPLICA_SHARDS * REPLICA_SEARCHES:
            raise AssertionError(f"replica {o['rank']}: pass A launched "
                                 f"{o['pass_a']} times")
        excused.append(same_ids(want, d.tolist(), o["ids"],
                                f"replica {o['rank']}"))
    if outs[0]["crc"] != outs[1]["crc"]:
        raise AssertionError("the replicas' fingerprints differ")
    print(f"phase replicas: {REPLICAS} processes on one card over "
          f"{outs[0]['backend']} (distboot's rule), each {REPLICA_SHARDS} "
          f"shards ({outs[0]['devices']}) of {REPLICA_N} rows; "
          f"ReplicatedServing.search B={BATCH} x {REPLICA_SEARCHES}: "
          + ", ".join(f"rank {o['rank']} {o['qps']:.1f} QPS, pass A "
                      f"{o['pass_a']}, gather-distance {o['gather']}"
                      for o in outs)
          + f"; ids as the single-process sharded search ({excused} places "
          f"excused as ties); verify_replicas equal, crc {outs[0]['crc']}; "
          f"{wall:.1f} s with the processes' start [{card}]", flush=True)
    return {"qps": outs[0]["qps"], "launches": outs[0]["pass_a"],
            "gather_launches": outs[0]["gather"], "wall_s": wall}


def shard_phase(torch, main: dict, exact: dict, card: str) -> dict:
    """Phase 20, with KEKTOR_TORCH_DEVICE_REPEAT=SHARDS: (a)-(c) in this
    process on cuda:0 repeated, (d) in two more."""
    import os

    from kektordb_tpu_torch import device as devlib
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    os.environ[devlib.DEVICE_REPEAT_ENV] = str(SHARDS)
    try:
        eng = Engine(EngineConfig(device=DEV, start_background=False)).open()
        a = shard_scan_read(torch, eng, main, exact, card)
        b = shard_more_reads(torch, eng, main, card)
        eng.close()
        del eng
        c = shard_engine_persist(torch, card)
    finally:
        os.environ.pop(devlib.DEVICE_REPEAT_ENV, None)
    d = replica_phase(torch, main, card)
    return {"scan": a, "more": b, "engine": c, "replicas": d}


class ErrorRecords(logging.Handler):
    """The ERROR records of the `kektordb` logger (the background loop's
    `log.exception`, which keeps the loop alive) while a `with` block
    runs."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(record)

    def __enter__(self) -> "ErrorRecords":
        logging.getLogger("kektordb").addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        logging.getLogger("kektordb").removeHandler(self)

    def check(self, label: str) -> None:
        if self.records:
            raise AssertionError(f"{label}: the kektordb logger recorded "
                                 f"{len(self.records)} ERROR(s), the first: "
                                 f"{self.format(self.records[0])}")


def in_threads(fns) -> list:
    """Runs each callable in a thread of its own and joins them all; the
    exceptions they raised."""
    import threading
    errors: list = []

    def guard(fn):
        try:
            fn()
        except Exception as ex:   # noqa: BLE001
            errors.append(ex)
    ts = [threading.Thread(target=guard, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errors


class ServeStorm:
    """Phase 21(a)'s threads over one Engine: SERVE_WRITERS writers of a
    fixed count of operations each, readers that run until the writers end.
    Every acknowledgement is recorded with its time.monotonic(); every
    reader checks each hit (a known id, a finite score, not an id whose
    delete was acknowledged before the search began)."""

    def __init__(self, eng, X: np.ndarray, Q: np.ndarray):
        import threading
        self.eng, self.Q = eng, Q
        idx = eng.indexes["graph"].index
        self.known = set(idx.ids.ext_to_row)
        per = SERVE_ROUNDS * SERVE_BATCH + SERVE_SINGLES
        self.plan = []
        for w in range(SERVE_WRITERS):
            Xw = X[w * per:(w + 1) * per]
            dels = [f"g{500 * i + 1 + w}" for i in range(SERVE_DELETES)]
            patches = [f"p{w * SERVE_PATCHES + i}"
                       for i in range(SERVE_PATCHES)]
            if any(e not in self.known for e in dels + patches):
                raise AssertionError("phase 21: a row to delete or patch is "
                                     "not in phase 15's index")
            batch_ids = [f"s{w}_{i}" for i in range(SERVE_ROUNDS
                                                    * SERVE_BATCH)]
            single_ids = [f"t{w}_{i}" for i in range(SERVE_SINGLES)]
            self.known.update(batch_ids + single_ids)
            self.plan.append((Xw, batch_ids, single_ids, dels, patches))
        self.added: dict = {}          # id -> (vector, ack time)
        self.deleted_at: dict = {}
        self.patched: list = []
        self.ops = [0] * SERVE_WRITERS
        self.reads = [0] * len(SERVE_READS)
        self.waits = [0.0] * len(SERVE_READS)
        self.stop = threading.Event()

    def writer(self, w: int) -> None:
        eng = self.eng
        Xw, batch_ids, single_ids, dels, patches = self.plan[w]
        nb = SERVE_ROUNDS * SERVE_BATCH
        per_round = [n // SERVE_ROUNDS for n in (SERVE_SINGLES, SERVE_DELETES,
                                                 SERVE_PATCHES)]
        for r in range(SERVE_ROUNDS):
            sl = slice(r * SERVE_BATCH, (r + 1) * SERVE_BATCH)
            eng.add_batch("graph", batch_ids[sl], Xw[sl])
            t = time.monotonic()
            for e, x in zip(batch_ids[sl], Xw[sl]):
                self.added[e] = (x, t)
            self.ops[w] += 1
            a, d, p = (slice(r * n, (r + 1) * n) for n in per_round)
            for e, x in zip(single_ids[a], Xw[nb:][a]):
                eng.add("graph", e, x, {"grp": 1})
                self.added[e] = (x, time.monotonic())
                self.ops[w] += 1
            for e in dels[d]:
                if not eng.delete("graph", e):
                    raise AssertionError(f"phase 21: delete of {e} found no "
                                         "row")
                self.deleted_at[e] = time.monotonic()
                self.ops[w] += 1
            for e in patches[p]:
                eng.update_metadata("graph", e, {"grp": 1})
                self.patched.append(e)
                self.ops[w] += 1

    def reader(self, r: int) -> None:
        B, filt = SERVE_READS[r]
        rng = np.random.default_rng(SERVE_SEED + r)
        while not self.stop.is_set():
            q = self.Q[rng.integers(0, len(self.Q) - B + 1):][:B]
            t0 = time.monotonic()
            res = self.eng.search("graph", q, k=K, filter=filt)
            self.waits[r] = max(self.waits[r], time.monotonic() - t0)
            if len(res) != B:
                raise AssertionError(f"phase 21: {len(res)} results for "
                                     f"{B} queries")
            for hits in res:
                for h in hits:
                    if h["id"] not in self.known \
                            or not np.isfinite(h["score"]):
                        raise AssertionError(f"phase 21: hit {h}")
                    gone = self.deleted_at.get(h["id"])
                    if gone is not None and gone < t0:
                        raise AssertionError(
                            f"phase 21: {h['id']} was deleted "
                            f"{t0 - gone:.3f} s before the search began")
            self.reads[r] += 1

    def run(self, snaps: list) -> list:
        """Writers and readers at once; once the writers end, waits (up to
        30 s) for the background thread's first snapshot, then stops the
        readers. The threads' exceptions."""
        import threading
        errors: list = []

        def guard(fn, *a):
            try:
                fn(*a)
            except Exception as ex:   # noqa: BLE001
                errors.append(ex)
                self.stop.set()
        writers = [threading.Thread(target=guard, args=(self.writer, w))
                   for w in range(SERVE_WRITERS)]
        readers = [threading.Thread(target=guard, args=(self.reader, r))
                   for r in range(len(SERVE_READS))]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join()
        t0 = time.monotonic()
        while not snaps and time.monotonic() - t0 < 30 and not errors:
            time.sleep(0.1)
        self.stop.set()
        for t in readers:
            t.join()
        return errors


def serve_storm(torch, src: str, Q: np.ndarray, card: str) -> dict:
    """Phase 21(a): phase 15's index (its data dir, copied after its close)
    opened as `serve` opens it, with the background thread (snapshots every
    SERVE_SNAPSHOT_S or 1,000 writes, maintenance every
    SERVE_MAINTENANCE_S); the storm (`ServeStorm`, phase 7's queries `Q`)
    with every launch count zeroed; then run_maintenance drains the link
    backlog, scan recall@K >= RECALL_MIN and beam recall@K >=
    BEAM_RECALL_MIN against the exact oracle over the live rows (both also
    printed for the index as opened); close() and a reopen: every
    acknowledged add back (`get`) and bit-equal, every acknowledged
    delete gone, every patch in place."""
    import gc as pygc
    import shutil
    import threading

    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.ops import distance as dist
    eng = Engine(EngineConfig(device=DEV, data_dir=src,
                              start_background=True,
                              snapshot_interval=SERVE_SNAPSHOT_S,
                              maintenance_interval=SERVE_MAINTENANCE_S))
    snaps, maint = [], []
    for name, out in (("save_snapshot", snaps), ("run_maintenance", maint)):
        def timed(fn=getattr(eng, name), out=out):
            t = time.perf_counter()
            res = fn()
            if threading.current_thread() is eng._bg:
                out.append(time.perf_counter() - t)
            return res
        setattr(eng, name, timed)   # the loop calls the instance's method
    per = SERVE_ROUNDS * SERVE_BATCH + SERVE_SINGLES
    X = make_sift_like(SERVE_WRITERS * per, DIM, seed=SERVE_SEED)
    Qr = Q[:RECALL_QUERIES]

    def recalls(idx) -> tuple[float, float]:
        """Scan (Engine.search) and beam recall@K against the exact
        oracle over the index's live rows."""
        cap = idx.state.vectors.shape[0]
        gt = dist.brute_force_topk(
            torch.from_numpy(Qr).to(DEV), idx.state.vectors, K,
            valid=torch.from_numpy(idx.ids.live_mask(cap)).to(DEV)
        )[1].cpu().numpy()
        ext = idx.ids.exts_array()
        want = [set(ext[g].tolist()) for g in gt]
        got = eng.search("graph", Qr, k=K)
        scan = float(np.mean([len({h["id"] for h in hits} & w) / K
                              for hits, w in zip(got, want)]))
        brows = np.asarray(idx.search(Qr, K, mode="beam")[1])
        beam = float(np.mean([len(set(ext[r[r >= 0]].tolist()) & w) / K
                              for r, w in zip(brows, want)]))
        return scan, beam
    try:
        with ErrorRecords() as errs:
            t0 = time.perf_counter()
            eng.open()
            open_s = time.perf_counter() - t0
            idx = eng.indexes["graph"].index
            n0 = len(idx)
            before = recalls(idx)
            storm = ServeStorm(eng, X, Q)
            errors, storm_s, counts = counted(
                torch, "phase 21 storm: readers, writers and the background "
                "thread", lambda: storm.run(snaps),
                ("scan_pass_a", "gather_dist"))
            if errors:
                raise AssertionError(f"phase 21: a storm thread raised: "
                                     f"{errors[0]!r}") from errors[0]
            if not snaps:
                raise AssertionError("phase 21: the background thread took "
                                     "no snapshot")
            backlog = len(idx._unlinked)
            t0 = time.perf_counter()
            eng.run_maintenance()
            drain_s = time.perf_counter() - t0
            if idx._unlinked:
                raise AssertionError("phase 21: run_maintenance left a link "
                                     "backlog")
            scan_rec, beam_rec = recalls(idx)
            t0 = time.perf_counter()
            eng.close()
            close_s = time.perf_counter() - t0
        errs.check("phase 21 storm")
        n1 = len(idx)
        del idx
        eng.indexes.clear()
        pygc.collect()
        torch.cuda.empty_cache()
        print(f"phase serve: phase 15's {n0}-row index opened with the "
              f"background thread (snapshots every {SERVE_SNAPSHOT_S} s or "
              f"1,000 writes, maintenance every {SERVE_MAINTENANCE_S} s) in "
              f"{open_s:.3f} s; storm {storm_s:.3f} s: writers "
              f"{storm.ops} ops (each {SERVE_ROUNDS} add_batch of "
              f"{SERVE_BATCH}, {SERVE_SINGLES} adds, {SERVE_DELETES} "
              f"deletes, {SERVE_PATCHES} patches), readers "
              + ", ".join(f"B={b}{' ' + f if f else ''}: {n} searches, "
                          f"longest {w:.3f} s"
                          for (b, f), n, w in zip(SERVE_READS, storm.reads,
                                                  storm.waits))
              + f"; background snapshots {len(snaps)} ("
              + ", ".join(f"{x:.3f}" for x in snaps)
              + f" s), maintenance ticks {len(maint)} (longest "
              f"{max(maint, default=np.nan):.3f} s); no ERROR logged; "
              f"backlog {backlog} rows drained in {drain_s:.3f} s; "
              f"{n1} rows: scan recall@{K} {scan_rec:.4f}, beam "
              f"{beam_rec:.4f} (exact oracle over the live rows; as "
              f"opened, {n0} rows: {before[0]:.4f}, {before[1]:.4f}); close() "
              f"{close_s:.3f} s [{card}]", flush=True)
        if scan_rec < RECALL_MIN or beam_rec < BEAM_RECALL_MIN:
            raise AssertionError(f"phase 21: recall scan {scan_rec}, beam "
                                 f"{beam_rec}")
        if storm.reads.count(0):
            print(f"phase serve: a reader never got in: {storm.reads} "
                  f"(the writer-preferring lock)", flush=True)

        t0 = time.perf_counter()
        e2 = Engine(EngineConfig(device=DEV, data_dir=src,
                                 start_background=False)).open()
        reopen_s = time.perf_counter() - t0
        idx2 = e2.indexes["graph"].index
        ids = sorted(storm.added)
        for e in ids:
            e2.get("graph", e)      # KeyError: an acknowledged add is gone
        rows = torch.tensor([idx2.ids.get(e) for e in ids], device=DEV)
        if not torch.equal(idx2.state.vectors[rows.long()], torch.from_numpy(
                np.stack([storm.added[e][0] for e in ids])).to(DEV)):
            raise AssertionError("phase 21: an acknowledged add did not "
                                 "read back bit-equal")
        back = [e for e in storm.deleted_at if idx2.ids.get(e) is not None]
        if back:
            raise AssertionError(f"phase 21: {len(back)} deleted ids back")
        if any(e2.get("graph", e)["metadata"].get("grp") != 1
               for e in storm.patched):
            raise AssertionError("phase 21: a metadata patch was lost")
        print(f"phase serve: reopened on the card in {reopen_s:.3f} s: "
              f"{len(ids)} acknowledged adds back and bit-equal, "
              f"{len(storm.deleted_at)} acknowledged deletes gone, "
              f"{len(storm.patched)} patches in place [{card}]", flush=True)
        e2._aof.close()
        e2.indexes.clear()
        del idx2, e2
    finally:
        eng._stop.set()     # close() did this unless the storm failed
        if eng._bg is not None:
            eng._bg.join(timeout=60)
        shutil.rmtree(src, ignore_errors=True)
        pygc.collect()
        torch.cuda.empty_cache()
    return {"storm_s": storm_s, "ops": storm.ops, "reads": storm.reads,
            "waits": storm.waits, "snapshots_s": snaps, "maint_s": maint,
            "counts": counts, "scan_recall": scan_rec,
            "beam_recall": beam_rec, "before": before, "open_s": open_s,
            "close_s": close_s,
            "reopen_s": reopen_s}


def decayed_as_host(eng, Q, res, now: float, label: str) -> int:
    """One decayed Engine.search result against the host path
    (`_assemble_fused` at `now`) on the index's scan output for the same
    queries, taken under the read lock: scores within FUSE_TOL, ids equal
    wherever the host's adjacent scores differ by more (its K + 1 hits
    show a tie across the K-th place). Returns the hits held."""
    h = eng.indexes["rag"]
    idx = h.index
    with eng._lock.read():
        d_dev, rows_dev, _ = idx.search_device(Q, 2 * K)
        host = eng._assemble_fused(
            h, idx, d_dev.cpu().numpy(),
            rows_dev.cpu().numpy().astype(np.int64), Q.shape[0], K + 1,
            text_rows=np.empty(0, np.int64),
            text_vals=np.empty(0, np.float64), alpha=0.5, decay=True,
            include_metadata=False, columnar=True, now=now)
    for b in range(Q.shape[0]):
        ds = np.array([x["score"] for x in res[b]])
        hs = np.array(host["scores"][b])
        if ds.shape[0] != K or not np.all(np.abs(ds - hs[:K]) <= FUSE_TOL):
            raise AssertionError(f"{label}: query {b} decayed scores {ds} "
                                 f"against the host's {hs}")
        gap = np.abs(np.diff(hs))
        sep = (np.minimum(np.r_[np.inf, gap], np.r_[gap, np.inf])
               > FUSE_TOL)[:K]
        di = np.array([x["id"] for x in res[b]])
        hi = np.array(host["ids"][b])[:K]
        if np.any(di[sep] != hi[sep]):
            raise AssertionError(f"{label}: query {b} ids {di} against the "
                                 f"host's {hi}")
    return Q.shape[0] * K


def serve_decay(torch, eng, Q, card: str) -> dict:
    """Phase 21(b), decay: on phase 11's memory-enabled engine, two
    threads run decayed B=HYBRID_B searches while a third reinforces
    REINFORCED of their top hits, DECAY_THREAD_ROUNDS rounds, at one fixed
    clock reading (time.time patched). A round: the reinforcer's writes
    and one search in each thread at once (held to the host path when no
    reinforce fell inside it), then one search in each thread with the
    writer idle, held to the host path (`decayed_as_host`)."""
    import threading
    from unittest import mock

    from kektordb_tpu_torch.ops import fuse
    now = time.time()
    cols = eng.indexes["rag"].meta.decay
    qs = (Q, np.roll(Q, HYBRID_B // 2, axis=0))
    tops = [eng.search("rag", q, k=K) for q in qs]
    start, done = (threading.Barrier(3, timeout=120) for _ in range(2))
    held, searches = [0, 0], [0, 0]

    def breaking(fn):
        def run(*a):
            try:
                fn(*a)
            except BaseException:
                start.abort()        # the other threads leave their wait
                done.abort()
                raise
        return run

    @breaking
    def searcher(t):
        for r in range(DECAY_THREAD_ROUNDS):
            start.wait()
            v0 = cols.version
            res = eng.search("rag", qs[t], k=K)
            clean = cols.version == v0
            done.wait()
            if clean and cols.version == v0:
                held[t] += decayed_as_host(eng, qs[t], res, now,
                                           f"phase 21 decay, round {r}")
            tops[t] = eng.search("rag", qs[t], k=K)
            held[t] += decayed_as_host(eng, qs[t], tops[t], now,
                                       f"phase 21 decay, round {r}, idle")
            searches[t] += 2

    @breaking
    def reinforcer():
        for r in range(DECAY_THREAD_ROUNDS):
            start.wait()
            for hits in tops[r % 2][:REINFORCED]:
                eng.reinforce("rag", hits[0]["id"])
            done.wait()

    fuse.build_decay_device.calls = fuse.update_decay_device.calls = 0
    t0 = time.perf_counter()
    with ErrorRecords() as errs, mock.patch("time.time", lambda: now):
        errors, sec, counts = counted(
            torch, "phase 21 decayed searches in 2 threads, reinforce in a "
            "third", lambda: in_threads([lambda: searcher(0),
                                         lambda: searcher(1), reinforcer]),
            ("scan_pass_a", "gather_dist"))
    errs.check("phase 21 decay")
    if errors:
        raise AssertionError(f"phase 21 decay: a thread raised: "
                             f"{errors[0]!r}") from errors[0]
    print(f"phase serve: decay, {DECAY_THREAD_ROUNDS} rounds of "
          f"{REINFORCED} reinforces beside 2 threads of decayed B={HYBRID_B} "
          f"searches: {sum(searches)} searches in {sec:.3f} s, "
          f"{sum(held)} hits held to the host path (scores within "
          f"{FUSE_TOL}); mirror builds {fuse.build_decay_device.calls}, "
          f"in-place refreshes {fuse.update_decay_device.calls} [{card}]",
          flush=True)
    eng.close()
    return {"searches": sum(searches), "held": sum(held), "s": sec,
            "counts": counts, "builds": fuse.build_decay_device.calls,
            "refreshes": fuse.update_decay_device.calls,
            "wall_s": time.perf_counter() - t0}


def serve_host(torch, eng, queries, card: str) -> dict:
    """Phase 21(b), host arena: phase 17's default host index; the same
    HOST_THREAD_BATCHES batches of BATCH queries run serially, then in two
    threads at once (the second in reverse order): every batch's ids equal
    the serial run's."""
    batches = [queries[i * BATCH:(i + 1) * BATCH]
               for i in range(HOST_THREAD_BATCHES)]

    def ids_of(q):
        return [[x["id"] for x in hits] for hits in eng.search("host", q,
                                                               k=K)]
    t0 = time.perf_counter()
    serial = [ids_of(q) for q in batches]
    serial_s = time.perf_counter() - t0
    got = [[None] * len(batches) for _ in range(2)]

    def run(t):
        order = range(len(batches)) if t == 0 else \
            reversed(range(len(batches)))
        for i in order:
            got[t][i] = ids_of(batches[i])
    # the default host index's projected sweep: pass A over the int8
    # mirror, the exact re-rank on the host
    errors, sec, counts = counted(
        torch, "phase 21 host sweeps in 2 threads",
        lambda: in_threads([lambda: run(0), lambda: run(1)]),
        ("scan_pass_a",))
    if errors:
        raise AssertionError(f"phase 21 host: a thread raised: "
                             f"{errors[0]!r}") from errors[0]
    bad = [(t, i) for t in range(2) for i in range(len(batches))
           if got[t][i] != serial[i]]
    print(f"phase serve: host arena, {HOST_THREAD_BATCHES} batches of "
          f"B={BATCH}: serial {serial_s:.3f} s, two threads at once "
          f"{sec:.3f} s ({2 * len(batches) * BATCH / sec:.1f} QPS), "
          f"{len(bad)} batches whose ids differ from the serial run's "
          f"[{card}]", flush=True)
    if bad:
        raise AssertionError(f"phase 21 host: batches {bad} differ from the "
                             "serial run")
    eng.close()
    return {"serial_s": serial_s, "threads_s": sec, "counts": counts}


_KILL_CHILD = '''
import sys
import threading
import time

import numpy as np
import torch
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.ops import distance as dist
from kektordb_tpu_torch.ops import scan
DEV = "cuda"
data, rows, batch, batches = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
# the kernel library's first use, from two threads at once (native.load
# builds or loads it under its lock), each call held to the plain version
g = torch.Generator().manual_seed(0)
V, Q = (torch.rand(n, 128, generator=g).to(DEV) for n in (8192, 64))
ids = torch.randint(0, 8192, (64, 32), generator=g).to(DEV)
got = [None, None]
ts = [threading.Thread(target=lambda t=t: got.__setitem__(
    t, dist.gathered(V, ids, Q, dist.L2))) for t in range(2)]
[t.start() for t in ts]
[t.join() for t in ts]
tol = 1e-5 * (Q.norm(dim=1)[:, None] + V[ids].norm(dim=2)) ** 2
worst = max(float(((x - dist.gathered_plain(V, ids, Q, dist.L2)).abs()
                   / tol).max()) for x in got)
print(f"FIRST {dist.gathered.launches} {worst:.4g}", flush=True)
X = np.load(rows)
e = Engine(EngineConfig(device=DEV, data_dir=data)).open()
e.create_index("kill")
print(f"DEVICE {e.device} {torch.cuda.get_device_name(e.device)} "
      f"background {e._bg is not None and e._bg.is_alive()}", flush=True)
n = 0
for b in range(batches):
    e.add_batch("kill", [f"k{i}" for i in range(n, n + batch)],
                X[n:n + batch])
    n += batch
    e._aof.flush(fsync=True)
    print(f"ACK {n - 1} batch", flush=True)
    top = e.search("kill", X[n - 1], k=1)[0][0]["id"]
    print(f"LAUNCHES pass_a {scan.pass_a.launches} gather_dist "
          f"{dist.gathered.launches} top {top}", flush=True)
while n < len(X):
    e.add("kill", f"k{n}", X[n])
    e._aof.flush(fsync=True)
    print(f"ACK {n}", flush=True)
    n += 1
print("DONE", flush=True)
time.sleep(600)
'''


def serve_kill(torch, card: str) -> dict:
    """Phase 21(c): a child process (the port alone) makes its first
    kernel calls from two threads at once (gather-distance, held to the
    plain version), opens Engine(device="cuda", data_dir) with the
    background thread, ingests
    KILL_BATCHES add_batch of KILL_BATCH SIFT-like rows into a default
    index (each fsynced, then acknowledged, then searched), then single
    adds, each fsynced and acknowledged; SIGKILLed once it acknowledged
    KILL_SINGLES of them, while it writes. Reopened on the card: every
    acknowledged id back, bit-equal, its own nearest row at distance 0
    through Engine.search; the beam drains the link backlog."""
    import os
    import queue
    import shutil
    import signal
    import tempfile
    import threading

    from kektordb_tpu_torch.engine import Engine, EngineConfig
    root = tempfile.mkdtemp(prefix="kill_", dir="build")
    X = make_sift_like(KILL_BATCHES * KILL_BATCH + KILL_POOL, DIM,
                       seed=KILL_SEED)
    proc = None
    try:
        np.save(os.path.join(root, "rows.npy"), X)
        child = os.path.join(root, "writer.py")
        with open(child, "w") as f:
            f.write(_KILL_CHILD)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, child, os.path.join(root, "data"),
             os.path.join(root, "rows.npy"), str(KILL_BATCH),
             str(KILL_BATCHES)], env=cli_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in
                                         proc.stdout] + [lines.put(None)],
                         daemon=True).start()
        log, acked, batches, singles = [], -1, 0, 0
        device = launches = first = None
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while batches < KILL_BATCHES or singles < KILL_SINGLES:
            try:
                ln = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError("phase 21 kill: the child timed out:\n"
                                     + "".join(log[-20:]))
            if ln is None or ln.startswith("DONE"):
                raise AssertionError("phase 21 kill: the child stopped "
                                     "writing before the kill:\n"
                                     + "".join(log[-20:]))
            log.append(ln)
            if ln.startswith("FIRST"):
                first = ln.split()[1:]
            elif ln.startswith("DEVICE"):
                device = ln.split(None, 1)[1].strip()
            elif ln.startswith("LAUNCHES"):
                launches = ln.split(None, 1)[1].strip()
            elif ln.startswith("ACK"):
                acked = int(ln.split()[1])
                if ln.strip().endswith("batch"):
                    batches += 1
                else:
                    singles += 1
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        child_s = time.perf_counter() - t0
        while (ln := lines.get(timeout=60)) is not None:   # printed, so
            if ln.startswith("ACK"):                        # acknowledged
                acked = int(ln.split()[1])
        if proc.returncode != -signal.SIGKILL:
            raise AssertionError(f"phase 21 kill: the child ended with "
                                 f"{proc.returncode}")
        counts_seen = launches.split()[1:4:2] if launches else []
        if not (device and device.startswith("cuda") and counts_seen
                and all(int(c) > 0 for c in counts_seen)):
            raise AssertionError(f"phase 21 kill: the child ran on "
                                 f"{device}, launches {launches}")
        if not first or int(first[0]) != 2 or float(first[1]) > 1.0:
            raise AssertionError(f"phase 21 kill: the child's first kernel "
                                 f"use from two threads: launches, max "
                                 f"|err| / tol: {first}")
        t0 = time.perf_counter()
        (eng, reopen_s), _, counts = counted(
            torch, "phase 21 reopen after the SIGKILL (replay)",
            lambda: (Engine(EngineConfig(device=DEV,
                                         data_dir=os.path.join(root, "data"),
                                         start_background=False)).open(),
                     time.perf_counter() - t0), ())
        idx = eng.indexes["kill"].index
        n = acked + 1
        rows = [idx.ids.get(f"k{i}") for i in range(n)]
        if any(r is None for r in rows):
            raise AssertionError(f"phase 21 kill: {rows.count(None)} "
                                 "acknowledged ids missing")
        if not torch.equal(idx.state.vectors[torch.tensor(rows, device=DEV)
                                             .long()],
                           torch.from_numpy(X[:n]).to(DEV)):
            raise AssertionError("phase 21 kill: an acknowledged vector did "
                                 "not read back bit-equal")
        worst = [0.0]

        def self_nearest():
            # at a distance within float rounding of 0 (RTOL of the L2
            # terms' magnitude, 4|v|^2), as phase 15 holds its re-adds
            for i in range(0, n, BATCH):
                q = X[i:min(n, i + BATCH)]
                tol = RTOL * 4.0 * np.einsum("bd,bd->b", q, q)
                for j, hits in enumerate(eng.search("kill", q, k=1)):
                    h = hits[0]
                    other = int(h["id"][1:])
                    worst[0] = max(worst[0], abs(h["distance"]))
                    if abs(h["distance"]) > tol[j] or (
                            other != i + j
                            and not np.array_equal(X[other], q[j])):
                        raise AssertionError(f"phase 21 kill: k{i + j} "
                                             f"found {h}")
        _, search_s, scounts = counted(
            torch, "phase 21 every acknowledged row searched for itself",
            self_nearest, ("scan_pass_a", "gather_dist"))
        had = len(idx._unlinked)
        _, beam_s, bcounts = counted(
            torch, "phase 21 beam after the SIGKILL",
            lambda: idx.search(X[:BEAM_B], K, mode="beam"),
            ("gather_dist",))
        if idx._unlinked:
            raise AssertionError("phase 21 kill: the beam left a backlog")
        print(f"phase serve: the child's first use of the kernel library "
              f"from two threads at once: {first[0]} gather_dist launches, "
              f"each within {float(first[1]):.3g} of its tolerance of the "
              f"plain version [{card}]", flush=True)
        print(f"phase serve: SIGKILL: the child ({device}) acknowledged "
              f"{batches} add_batch of {KILL_BATCH} and {singles} single "
              f"adds (last k{acked}), launches {launches}, killed after "
              f"{child_s:.3f} s; reopened on the card in {reopen_s:.3f} s "
              f"(replay gather_dist launches {counts['gather_dist']}): "
              f"{n} acknowledged ids back, bit-equal, each its own nearest "
              f"row (max |d| {worst[0]:.6g}; {search_s:.3f} s); the beam "
              f"drained "
              f"{had} unlinked rows ({beam_s:.3f} s, gather_dist "
              f"{bcounts['gather_dist']}) [{card}]", flush=True)
        eng._aof.close()
        eng.indexes.clear()
        del idx, eng
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    return {"acked": n, "batches": batches, "singles": singles,
            "child_s": child_s, "reopen_s": reopen_s, "max_d": worst[0],
            "search_counts": scounts, "beam_counts": bcounts}


def serve_phase(torch, persist: dict, rag, rag_q, host_eng, main: dict,
                card: str) -> dict:
    """Phase 21: the port as `serve` deploys it, on the card."""
    t0 = time.perf_counter()
    storm = serve_storm(torch, persist["serve_dir"],
                        persist["serve_queries"], card)
    decay = serve_decay(torch, rag, rag_q, card)
    host = serve_host(torch, host_eng, main["queries"], card)
    kill = serve_kill(torch, card)
    wall = time.perf_counter() - t0
    print(f"phase serve: {wall:.1f} s [{card}]", flush=True)
    return {"storm": storm, "decay": decay, "host": host, "kill": kill,
            "wall_s": wall}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"phase device: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from kektordb_tpu_torch import host_native, native
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    print(f"phase build: {lib.name} in {build_s:.3f} s (one nvcc per "
          "source, in parallel, then one link)", flush=True)
    t0 = time.perf_counter()
    hlib = host_native.build()
    print(f"phase build: {hlib.name} (the host runtime, g++ "
          f"{' '.join(host_native.CXX_FLAGS)}) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for ln in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"phase build: {ln.strip()}", flush=True)

    from kektordb_tpu_torch.ops import scan as scan_forms
    max_err = check_kernels(torch)
    check_pass_b(torch, card)
    main = main_path(torch, card)
    exact = exact_phase(torch, main, card)
    head = time_pass_a(torch, card)
    max_err = max(max_err, head["max_abs_err"])
    print(f"phase times: ingest {main['ingest_s']:.3f} s, Engine.search "
          f"{main['qps']:.1f} QPS at B={BATCH}, recall@{K} "
          f"{main['recall']:.4f} [{card}]", flush=True)
    gather = check_gather(torch, card)
    graph = graph_path(torch, card)
    persist = persist_phase(torch, graph, card)
    host_topk = host_topk_check(torch, main, card)
    vacuum_and_import(torch, card)
    probes = probes_phase(torch, card)
    eng, Q, path_errs = hybrid_phase(torch, card)
    decay_phase(torch, eng, Q, card)
    bf16 = graph_bf16_phase(torch, card)
    int8 = int8_phase(torch, card)
    proj = proj_phase(torch, card)
    host = host_phase(torch, main, proj, card)
    server = server_phase(torch, main, card)
    minilm = minilm_phase(torch, card)
    shards = shard_phase(torch, main, exact, card)
    serve = serve_phase(torch, persist, eng, Q, host.pop("engine"), main,
                        card)

    leaked = [m for m in sys.modules
              if m in ("jax", "jaxlib", "kektordb_tpu", "ml_dtypes")
              or m.startswith(("jax.", "jaxlib.", "kektordb_tpu.",
                               "ml_dtypes."))]
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")
    print(f"phase times: persistence at {GRAPH_N} x {DIM}: save "
          f"{persist['save_s']:.3f} s, load {persist['load_s']:.3f} s, replay "
          f"{persist['replay_s']:.3f} s ({persist['replay_rows_s']:.1f} "
          f"rows/s; frame scanner share: C++ "
          f"{persist['cpp_scan_share']:.5f}, Python "
          f"{persist['scan_share']:.5f}), {persist['bytes']} bytes on "
          f"disk; host exact top-k {host_topk['host_ms']:.1f} ms against "
          f"the card's {host_topk['card_ms']:.3f}; projected read "
          f"{proj['qps']:.1f} QPS at recall@{K} {proj['recall']:.4f} "
          f"(full-dimension {proj['full_qps']:.1f} QPS at "
          f"{proj['full_recall']:.4f}) [{card}]", flush=True)
    print(f"phase times: host arena at {N_BASE} x {DIM}: default (projected) "
          f"{host['auto']['qps']:.1f} QPS at recall@{K} "
          f"{host['auto']['recall']:.4f}, full dimension "
          f"{host['full']['qps']:.1f} QPS at {host['full']['recall']:.4f}, "
          f"H2D {host['full']['parts']['sweep_gbs']:.2f} GB/s against the "
          f"bare pinned copy's {host['full']['parts']['link_gbs']:.2f}; "
          f"HTTP plain {server['reads']['qps']['plain']:.1f}, columnar "
          f"{server['reads']['qps']['columnar']:.1f}, b64 "
          f"{server['reads']['qps']['b64']:.1f} QPS [{card}]", flush=True)
    mm = ", ".join(f"{k} {v['encode_per_s']:.1f}"
                   for k, v in minilm.items())
    print(f"phase times: MiniLM embeddings/s (encode): {mm}; sharded scan "
          f"(S={SHARDS}) {shards['scan']['qps']:.1f} QPS at recall@{K} "
          f"{shards['scan']['recall']:.4f} beside phase 4's "
          f"{main['qps']:.1f} at {main['recall']:.4f}; replicated "
          f"({REPLICAS} processes x {REPLICA_SHARDS} shards) "
          f"{shards['replicas']['qps']:.1f} QPS [{card}]", flush=True)
    st, kl = serve["storm"], serve["kill"]
    print(f"phase times: serving as deployed (phase 21, {serve['wall_s']:.1f}"
          f" s): storm {st['storm_s']:.3f} s, writers {st['ops']} ops, "
          f"readers {st['reads']} searches (longest "
          f"{max(st['waits']):.3f} s), background snapshots "
          f"{len(st['snapshots_s'])} (longest "
          f"{max(st['snapshots_s']):.3f} s); SIGKILL reopen "
          f"{kl['reopen_s']:.3f} s for {kl['acked']} acknowledged rows "
          f"[{card}]", flush=True)
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
        "launches_by_path": {
            "phase 4, scan read (fast form)": main["launches"],
            "phase 15, compressed int8 read (form 5)":
                persist["int8_launches"],
            "phase 16, projected read (bf16 form, D=32)":
                proj["pass_a_launches"],
            "phase 17, host sweep, full dimension (form 1)":
                host["full"]["counts"]["scan_pass_a"],
            "phase 17, host sweep, projected mirror (form 5, D=32)":
                host["auto"]["counts"]["scan_pass_a"],
            "phase 17, host sweep, int8 (form 3)":
                host["span"]["int8"]["counts"]["scan_pass_a"],
            "phase 17, host sweep, bf16 (form 2)":
                host["span"]["bf16"]["counts"]["scan_pass_a"],
            "phase 18, HTTP reads of phase 4's index":
                server["reads"]["counts"]["scan_pass_a"],
            f"phase 20, sharded scan read, {N_BATCHES} searches of "
            f"{SHARDS} shards": shards["scan"]["launches"],
            f"phase 20, sharded projected read (bf16 form, D={PROJ_P}), 2 "
            "searches": shards["more"]["proj_launches"],
            "phase 20, sharded int8 read (form 3), 2 searches":
                shards["more"]["int8_launches"],
            f"phase 20, replicated read, rank 0, {REPLICA_SEARCHES} "
            f"searches of {REPLICA_SHARDS} shards":
                shards["replicas"]["launches"],
            "phase 21, serve storm (readers, writers, background thread)":
                serve["storm"]["counts"]["scan_pass_a"],
            "phase 21, decayed searches in 2 threads":
                serve["decay"]["counts"]["scan_pass_a"],
            "phase 21, host sweeps in 2 threads":
                serve["host"]["counts"]["scan_pass_a"],
            "phase 21, every row searched after the SIGKILL":
                serve["kill"]["search_counts"]["scan_pass_a"]},
        "max_abs_err": max(max_err, path_errs["scan_pass_a"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "issue_ms": head["issue_ms"],
        "matmul_ms": head["matmul_ms"], "form": "f32 fast (1, bf16)",
        "pass_b_device_ms": head["pass_b"]["device_ms"],
        "pass_b_topk_alone_device_ms": head["pass_b"]["topk_device_ms"]}]
    # pass A's exact forms and int8 x int8: the same kernel, each form's
    # own product, timed at the shape of the user path that runs it
    # (phase 13's is phase 5's serving shape; phase 14's B=1024 over its
    # 2^19-row arena at D=384), launches on that path; forms 3 and 4 also
    # carry their serving-shape time (phase 5)
    for name, launches, path, f in (
            ("f32 exact", exact["launches"], "phase 13, scan_exact",
             head["forms"]["f32 exact"]),
            ("int8", int8["launches"], "phase 14, int8_symmetric",
             int8["int8"]),
            ("asym exact", int8["asym_launches"],
             "phase 14, int8 with scan_exact", int8["asym exact"])):
        serving = head["forms"][name]
        kernels.append({
            "name": f"scan_pass_a form {f['form']} ({name})",
            "route": "cuda",
            "source": "kektordb_tpu_torch/csrc/scan_pass_a_wgmma.cu",
            "replaces": "kektordb_tpu/ops/scan.py:175",
            "launches": launches, "launches_path": path,
            "max_abs_err": max(f["max_abs_err"], serving["max_abs_err"]),
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None, "issue_ms": f["issue_ms"],
            "matmul_ms": f["matmul_ms"], "timed_at": f["shape"],
            "serving_shape_ms": serving["ms"],
            "serving_shape_bound_ms": serving["bound_ms"]})
    kernels += [{
        "name": "gather_dist", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/gather_dist.cu",
        "replaces": "scripts/pallas_gather.py:120, "
                    "scripts/pallas_gather2.py:170",
        "launches": graph["beam_launches"],
        "max_abs_err": max(gather["max_abs_err"], path_errs["gather_dist"]),
        "ms": gather["ms"],
        "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
        "bound_by": gather["bound_by"], "library_ms": None,
        "by_case": gather["by_case"],
        "launches_by_path": {
            "graph build (1M f32)": graph["build_launches"],
            "beam (f32 index)": graph["beam_launches"],
            f"graph build ({BF16_N} rows, bf16)": bf16["build_launches"],
            "beam (bf16 index)": bf16["beam_launches"],
            "journaled adds, graph linked (phase 15)":
                persist["add_launches"],
            "replay of the journaled adds (phase 15)":
                persist["replay_launches"],
            "beam on the reopened indexes (phase 15)":
                persist["beam_launches"],
            "projected re-rank (phase 16)": proj["gather_launches"],
            "host sweep re-rank, full dimension (phase 17)":
                host["full"]["counts"]["gather_dist"],
            "HTTP reads of phase 4's index (phase 18)":
                server["reads"]["counts"]["gather_dist"],
            "beam after optimize_layout (phase 12)":
                bf16["layout"]["beam_launches"],
            f"sharded graph build, {shards['more']['chunks']} chunks "
            "(phase 20)": shards["more"]["build_launches"],
            "sharded beam (phase 20)": shards["more"]["beam_launches"],
            "sharded scan re-rank (phase 20)":
                shards["scan"]["gather_launches"],
            "replicated read re-rank, rank 0 (phase 20)":
                shards["replicas"]["gather_launches"],
            "serve storm: re-ranks and the background thread's links "
            "(phase 21)": serve["storm"]["counts"]["gather_dist"],
            "decayed searches in 2 threads (phase 21)":
                serve["decay"]["counts"]["gather_dist"],
            "self-searches and beam after the SIGKILL (phase 21)":
                serve["kill"]["search_counts"]["gather_dist"]
                + serve["kill"]["beam_counts"]["gather_dist"]},
        "chunk_share_bf16_build": bf16["chunk_gather_share"]}]
    # the projected read's new shapes: pass A's bf16 form at depth PROJ_P
    # and the full-dimension re-rank, each timed on that read's operands
    pa, ga = proj["pass_a"], proj["gather"]
    kernels += [{
        "name": f"scan_pass_a form {pa['form']} (bf16, projected D={PROJ_P})",
        "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/scan_pass_a_wgmma.cu",
        "replaces": "kektordb_tpu/ops/scan.py:175",
        "launches": proj["pass_a_launches"],
        "launches_path": "phase 16, projected read",
        "max_abs_err": pa["max_abs_err"], "ms": pa["ms"],
        "plain_ms": pa["plain_ms"], "bound_ms": pa["bound_ms"],
        "bound_by": pa["bound_by"], "library_ms": None,
        "issue_ms": pa["issue_ms"], "timed_at": pa["shape"]}, {
        "name": "gather_dist (projected re-rank)", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/gather_dist.cu",
        "replaces": "scripts/pallas_gather.py:120, "
                    "scripts/pallas_gather2.py:170",
        "launches": proj["gather_launches"],
        "launches_path": "phase 16, projected read",
        "max_abs_err": ga["max_abs_err"], "ms": ga["ms"],
        "plain_ms": ga["plain_ms"], "bound_ms": ga["bound_ms"],
        "bound_by": ga["bound_by"], "library_ms": None,
        "issue_ms": ga["issue_ms"], "timed_at": ga["shape"]}]
    # the host sweep's shapes (phase 17): form 1 over one streamed chunk
    # and its re-rank's gather-distance, form 5 over the projected mirror
    # at B=BATCH and PROJ_B; launches on the sweep that runs each
    fl = {n: host[n]["counts"]["scan_pass_a forms"]
          for n in ("full", "auto", "aniso_proj")}
    for f, launches, path in (
            (host["form1"], fl["full"][scan_forms.FORM_F32_FAST],
             "phase 17, host sweep, full dimension"),
            (host["form5"], fl["auto"][scan_forms.FORM_ASYM_FAST],
             "phase 17, host sweep, projected mirror (default index)"),
            (host["form5_b1024"], fl["aniso_proj"][scan_forms.FORM_ASYM_FAST],
             "phase 17, host sweep, anisotropic projected")):
        kernels.append({
            "name": f"scan_pass_a form {f['form']} (host sweep, "
                    f"B={f['shape'][0]}, D={f['shape'][2]})",
            "route": "cuda",
            "source": "kektordb_tpu_torch/csrc/scan_pass_a_wgmma.cu",
            "replaces": "kektordb_tpu/ops/scan.py:175",
            "launches": launches, "launches_path": path,
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "issue_ms": f["issue_ms"], "timed_at": f["shape"]})
    hg = host["gather"]
    kernels.append({
        "name": "gather_dist (host sweep re-rank)", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/gather_dist.cu",
        "replaces": "scripts/pallas_gather.py:120, "
                    "scripts/pallas_gather2.py:170",
        "launches": host["full"]["counts"]["gather_dist"],
        "launches_path": "phase 17, host sweep, full dimension",
        "max_abs_err": hg["max_abs_err"], "ms": hg["ms"],
        "plain_ms": hg["plain_ms"], "bound_ms": hg["bound_ms"],
        "bound_by": hg["bound_by"], "library_ms": None,
        "issue_ms": hg["issue_ms"], "timed_at": hg["shape"]})
    sf = shards["scan"]["held"]
    kernels.append({
        "name": f"scan_pass_a form {sf['form']} (sharded scan, one shard of "
                f"{SHARDS})", "route": "cuda",
        "source": "kektordb_tpu_torch/csrc/scan_pass_a_wgmma.cu",
        "replaces": "kektordb_tpu/ops/scan.py:175",
        "launches": shards["scan"]["launches"],
        "launches_path": "phase 20, sharded scan read",
        "max_abs_err": max(sf["max_abs_err"], shards["scan"]["gather_err"]),
        "ms": sf["ms"], "plain_ms": sf["plain_ms"],
        "bound_ms": sf["bound_ms"], "bound_by": sf["bound_by"],
        "library_ms": None, "issue_ms": sf["issue_ms"],
        "timed_at": sf["shape"]})
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
