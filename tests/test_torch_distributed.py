"""Replicated serving in the port (kektordb_tpu_torch/parallel/
distributed.py, distboot.py) held to the JAX package's.

1. One process: a 2 replicas x 4 shards grid of the CPU repeated 8 times
   (the device-repeat setting). ReplicatedServing returns the global rows
   of the plain sharded search, and of the reference's ReplicatedServing
   on its 8 virtual devices, row for row (the CPU scan is exact in both).
2. Two processes: a real torch.distributed group over gloo, each rank a
   full replica of 4 CPU shards; the gathered ids equal the
   single-process sharded search on the same rows, and verify_replicas
   agrees. Then the reference's lifecycle case: a replica dies mid-serve,
   the survivor serves locally and keeps writing, the dead one comes back
   from the survivor's checkpoint and journal tail, and the re-formed
   group's fingerprints and answers agree. Every child has its own
   timeout, so a hang fails one test and not the suite.
3. The backend rule, and the CLI's distributed flags forming a two-rank
   group of `serve` processes.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import requests
import torch

from kektordb_tpu.index import HNSWConfig as JConfig
from kektordb_tpu.parallel import ReplicatedServing as JReplicated
from kektordb_tpu.parallel import ShardedHNSW as JSharded
from kektordb_tpu.parallel import make_mesh as jmake_mesh
from kektordb_tpu.parallel import replica_mesh as jreplica_mesh
from kektordb_tpu_torch import device as devlib
from kektordb_tpu_torch import distboot
from kektordb_tpu_torch.index import BruteForceIndex, HNSWConfig
from kektordb_tpu_torch.parallel import (ReplicatedServing, ShardedHNSW,
                                         make_mesh, replica_mesh)

ROOT = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 150


@pytest.fixture(scope="module")
def setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(devlib.DEVICE_REPEAT_ENV, "8")
        rng = np.random.default_rng(7)
        X = rng.normal(size=(2000, 24)).astype(np.float32)
        ids = [f"v{i}" for i in range(2000)]
        cfg = dict(m=8, ef_construction=64, ef_search=64, chunk=256)
        sh = ShardedHNSW(24, "euclidean", config=HNSWConfig(**cfg),
                         mesh=make_mesh(4, "cpu"))
        sh.add_batch(ids, X)
        ref = JSharded(24, "euclidean", config=JConfig(**cfg),
                       mesh=jmake_mesh(4))
        ref.add_batch(ids, X)
        oracle = BruteForceIndex(24, device="cpu")
        oracle.add_batch(ids, X)
        yield sh, ref, oracle, X, rng


class TestReplicatedServing:
    def test_parity_with_sharded_search(self, setup):
        sh, ref, oracle, X, rng = setup
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(devlib.DEVICE_REPEAT_ENV, "8")
            rep = ReplicatedServing(sh, replica_mesh(2, "cpu"))
        assert rep.n_replicas == 2
        q = rng.normal(size=(48, 24)).astype(np.float32)
        d_r, g_r = rep.search(q, 10)
        d_s, g_s = sh.search(q, 10)
        np.testing.assert_array_equal(g_r, g_s)
        np.testing.assert_allclose(d_r, d_s, rtol=1e-6, atol=1e-6)
        d_j, g_j = JReplicated(ref, jreplica_mesh(2)).search(q, 10)
        np.testing.assert_array_equal(g_r, np.asarray(g_j))
        np.testing.assert_allclose(d_r, np.asarray(d_j), rtol=1e-5,
                                   atol=1e-4)

    def test_recall_vs_oracle(self, setup):
        sh, ref, oracle, X, rng = setup
        rep = ReplicatedServing(sh, [make_mesh(4, "cpu")] * 2)
        q = X[:64] + 0.01 * rng.normal(size=(64, 24)).astype(np.float32)
        hits = rep.search_ids(q, 1)
        assert sum(1 for b in range(64)
                   if hits[b] and hits[b][0][0] == f"v{b}") >= 60
        assert rep.verify_replicas()["equal"]

    def test_write_then_serve_invalidates_lift(self, setup):
        sh, ref, oracle, X, rng = setup
        rep = ReplicatedServing(sh, [make_mesh(4, "cpu")] * 2)
        rep.search(rng.normal(size=(16, 24)).astype(np.float32), 5)
        v = rng.normal(size=(24,)).astype(np.float32)
        sh.add("fresh", v)
        hits = rep.search_ids(v[None], 1)
        assert hits[0] and hits[0][0][0] == "fresh"

    def test_copies_on_other_devices(self, setup):
        """One process, a grid whose second row names other devices:
        that replica is a copy of the index on them, remade after a
        write, with the same answers."""
        sh, ref, oracle, X, rng = setup
        other = [torch.device("cpu", 0)] * 4
        rep = ReplicatedServing(sh, [sh.mesh, other])
        copies = rep._replicas()
        assert copies[0] is sh and copies[1] is not sh
        assert copies[1].mesh == other
        q = rng.normal(size=(40, 24)).astype(np.float32)
        np.testing.assert_array_equal(rep.search(q, 5)[1],
                                      sh.search(q, 5)[1])
        assert rep.verify_replicas()["equal"]
        v = rng.normal(size=(24,)).astype(np.float32) + 9.0
        sh.add("copied", v)
        assert rep.search_ids(v[None], 1)[0][0][0] == "copied"
        assert rep._replicas()[1] is not copies[1]

    def test_mesh_shape_validation(self, setup):
        sh, *_ = setup
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(devlib.DEVICE_REPEAT_ENV, "8")
            with pytest.raises(ValueError):
                ReplicatedServing(sh, replica_mesh(8, "cpu"))   # S = 1
            with pytest.raises(ValueError):
                replica_mesh(3, "cpu")                          # 8 % 3


def test_backend_rule(monkeypatch):
    assert distboot.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distboot.backend_for("cuda", 2) == "gloo"    # share one card
    assert distboot.backend_for("cuda", 1) == "nccl"
    assert distboot.rank_device("cuda", 1) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distboot.backend_for("cuda", 4) == "nccl"    # a card each
    assert distboot.rank_device("cuda", 3) == torch.device("cuda", 3)
    with pytest.raises(ValueError, match="process group needs"):
        distboot.init_distributed("localhost:1", num_processes=2,
                                  process_id=2, device="cpu")


# -- two processes -----------------------------------------------------------

_COMMON = textwrap.dedent("""
    import hashlib, json, os, sys
    import numpy as np
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from kektordb_tpu_torch.distboot import init_distributed
    init_distributed(f"localhost:{port}", num_processes=nproc,
                     process_id=pid, device="cpu", timeout_s=90)
    import torch.distributed as tdist
    from kektordb_tpu_torch.index import HNSWConfig
    from kektordb_tpu_torch.parallel import ShardedHNSW
    from kektordb_tpu_torch.parallel import distributed as dlib
    assert tdist.get_backend() == "gloo" and tdist.get_world_size() == nproc
    CFG = dict(m=8, ef_construction=48, chunk=128)
    rng = np.random.default_rng(11)
    X = rng.normal(size=(600, 16)).astype(np.float32)
    Q = X[:32] + 0.01 * rng.normal(size=(32, 16)).astype(np.float32)

    def build(ids, vecs):
        mesh2d = dlib.replica_mesh(device="cpu")
        sh = ShardedHNSW(16, "euclidean", config=HNSWConfig(**CFG),
                         mesh=dlib.local_shard_mesh(mesh2d))
        sh.add_batch(ids, vecs)
        return sh, mesh2d

    def ans_hash(obj, q, k=3):
        d, g = obj.search(q, k)
        return hashlib.md5(np.sort(np.asarray(g, np.int64), 1)
                           .tobytes()).hexdigest()[:12]
""")

_WORKER = _COMMON + textwrap.dedent("""
    sh, mesh2d = build([f"v{i}" for i in range(600)], X)
    rep = dlib.ReplicatedServing(sh, mesh2d)
    assert rep.n_replicas == nproc
    d, g = rep.search(Q, 5)
    print("IDS=" + json.dumps(np.asarray(g).tolist()), flush=True)
    print(f"FP={rep.verify_replicas()['equal']}", flush=True)
    tdist.destroy_process_group()
""")

_LIFECYCLE = _COMMON + textwrap.dedent("""
    ddir, phase = sys.argv[4], sys.argv[5]
    ck = os.path.join(ddir, "ckpt.npz")
    jtail = os.path.join(ddir, "journal_tail.npz")
    if phase == "A":
        sh, mesh2d = build([f"v{i}" for i in range(600)], X)
        rep = dlib.ReplicatedServing(sh, mesh2d)
        print(f"FPA={rep.verify_replicas()['equal']}", flush=True)
        print(f"ANSA={ans_hash(rep, Q)}", flush=True)
        if pid == 1:
            os._exit(7)                       # a replica dies, no cleanup
        # the survivor serves locally, with the same answers
        print(f"LOCA={ans_hash(rep.sharded, Q)}", flush=True)
        np.savez(ck, X=X)
        X2 = np.random.default_rng(13).normal(size=(30, 16)).astype(
            np.float32)
        sh.add_batch([f"w{i}" for i in range(30)], X2)
        np.savez(jtail, X2=X2)
        assert sh.search_ids(X2[:1], 1)[0][0][0] == "w0"
        print("DONEA", flush=True)
        os._exit(0)                           # the peer is gone
    snap, tail = np.load(ck), np.load(jtail)
    sh, mesh2d = build([f"v{i}" for i in range(600)], snap["X"])
    sh.add_batch([f"w{i}" for i in range(30)], tail["X2"])
    rep = dlib.ReplicatedServing(sh, mesh2d)
    print(f"FPB={rep.verify_replicas()['equal']}", flush=True)
    print(f"ANSB={ans_hash(rep, Q)}", flush=True)
    assert rep.search_ids(tail["X2"][:1], 1)[0][0][0] == "w0"
    print("DONEB", flush=True)
    tdist.destroy_process_group()
""")


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env[devlib.DEVICE_REPEAT_ENV] = "4"        # 4 CPU shards per rank
    for k in ("KEKTOR_COORDINATOR", "KEKTOR_NUM_PROCESSES",
              "KEKTOR_PROCESS_ID"):
        env.pop(k, None)
    return env


def _run_cluster(script, nproc, extra=lambda pid: []):
    """Start nproc ranks of `script`; (returncodes, outputs). Each child
    has CHILD_TIMEOUT seconds; on a timeout every child is killed and the
    test fails."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(nproc), port]
        + extra(pid), env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-2000:] for p in procs]
        pytest.fail("the process group hung:\n" + "\n".join(tails))
    return [p.returncode for p in procs], outs


def _fields(out):
    return dict(line.split("=", 1) for line in out.splitlines()
                if "=" in line and line.split("=", 1)[0].isupper())


def test_two_process_gloo_cluster(tmp_path):
    wf = tmp_path / "worker.py"
    wf.write_text(_WORKER)
    rcs, outs = _run_cluster(wf, 2)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-3000:]
    f0, f1 = _fields(outs[0]), _fields(outs[1])
    assert f0["FP"] == f1["FP"] == "True"
    assert f0["IDS"] == f1["IDS"]
    # the single-process sharded search over the same rows
    rng = np.random.default_rng(11)
    X = rng.normal(size=(600, 16)).astype(np.float32)
    Q = X[:32] + 0.01 * rng.normal(size=(32, 16)).astype(np.float32)
    sh = ShardedHNSW(16, "euclidean",
                     config=HNSWConfig(m=8, ef_construction=48, chunk=128),
                     mesh=[torch.device("cpu")] * 4)
    sh.add_batch([f"v{i}" for i in range(600)], X)
    assert json.loads(f0["IDS"]) == sh.search(Q, 5)[1].tolist()


def test_replica_lifecycle_kill_rejoin(tmp_path):
    wf = tmp_path / "lifecycle.py"
    wf.write_text(_LIFECYCLE)
    d0, d1 = tmp_path / "r0", tmp_path / "r1"
    d0.mkdir()
    d1.mkdir()
    dirs = lambda ph: lambda pid: [str(d0 if pid == 0 else d1), ph]  # noqa
    rcs, outs = _run_cluster(wf, 2, dirs("A"))
    assert rcs[1] == 7, outs[1][-2000:]           # replica 1 died
    assert rcs[0] == 0, outs[0][-3000:]           # the survivor finished
    a0 = _fields(outs[0])
    assert a0["FPA"] == "True" and a0["LOCA"] == a0["ANSA"]
    assert "DONEA" in outs[0]
    shutil.copy(d0 / "ckpt.npz", d1 / "ckpt.npz")
    shutil.copy(d0 / "journal_tail.npz", d1 / "journal_tail.npz")
    rcs, outs = _run_cluster(wf, 2, dirs("B"))
    for rc, out in zip(rcs, outs):
        assert rc == 0 and "DONEB" in out, out[-3000:]
    b0, b1 = _fields(outs[0]), _fields(outs[1])
    assert b0["FPB"] == b1["FPB"] == "True"
    assert b0["ANSB"] == b1["ANSB"]


def test_cli_distributed_flags_form_a_group(tmp_path):
    """Two `serve` processes given --coordinator / --num-processes /
    --process-id join one gloo group (--device cpu), then each serves its
    own replica over HTTP."""
    coord = f"localhost:{_free_port()}"
    ports = [int(_free_port()) for _ in range(2)]
    procs = []
    try:
        for pid in range(2):
            env = _env()
            env["HOME"] = str(tmp_path)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kektordb_tpu_torch", "serve",
                 "--device", "cpu", "--port", str(ports[pid]),
                 "--host", "127.0.0.1", "--log-level", "warning",
                 "--data-dir", str(tmp_path / f"d{pid}"),
                 "--coordinator", coord, "--num-processes", "2",
                 "--process-id", str(pid)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + CHILD_TIMEOUT
        up = [False, False]
        while not all(up) and time.time() < deadline:
            for i, port in enumerate(ports):
                assert procs[i].poll() is None, procs[i].communicate()[0]
                try:
                    up[i] = requests.get(f"http://127.0.0.1:{port}/healthz",
                                         timeout=2).status_code == 200
                except requests.ConnectionError:
                    pass
            time.sleep(0.5)
        assert all(up)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
