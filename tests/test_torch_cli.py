"""The port's CLI, `python -m kektordb_tpu_torch`, as a subprocess on the
CPU (`--device cpu`): `serve` with a data dir answers /healthz, creates,
adds and searches over HTTP, and after a SIGTERM and a restart reads back
every acknowledged vector; `mcp` speaks JSON-RPC over stdio (61 tools, a
vector tool call); `tui` and the distributed flags no longer name a
ROADMAP item: `tui` without a terminal stops in curses, and a distributed
flag without the other two is refused, naming what a process group
needs. The child runs without a card in sight and without the JAX
package on any import path it takes."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import requests

ROOT = Path(__file__).resolve().parent.parent


def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["HOME"] = str(tmp_path)         # `setup` and caches stay here
    for k in ("KEKTOR_PORT", "KEKTOR_DATA_DIR", "KEKTOR_TOKEN",
              "KEKTOR_CONFIG", "KEKTOR_COORDINATOR", "KEKTOR_PROCESS_ID",
              "KEKTOR_NUM_PROCESSES", "KEKTOR_EMBEDDER_URL"):
        env.pop(k, None)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(*args):
    return [sys.executable, "-m", "kektordb_tpu_torch", *args]


class Serve:
    def __init__(self, tmp_path, data_dir):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.proc = subprocess.Popen(
            _cli("serve", "--device", "cpu", "--host", "127.0.0.1",
                 "--port", str(self.port), "--data-dir", str(data_dir),
                 "--log-level", "warning"),
            cwd=ROOT, env=_env(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        deadline = time.time() + 120
        while time.time() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(self.proc.stdout.read())
            # a probe that is refused, or that a host busy with other
            # processes does not answer in 2 s, is retried until the
            # deadline
            try:
                if requests.get(self.base + "/healthz",
                                timeout=2).status_code == 200:
                    return
            except (requests.ConnectionError, requests.Timeout):
                time.sleep(0.2)
        self.proc.kill()
        raise AssertionError("server did not answer /healthz")

    def stop(self):
        self.proc.send_signal(signal.SIGTERM)
        out, _ = self.proc.communicate(timeout=120)
        assert self.proc.returncode == 0, out
        assert "Traceback" not in out, out


def test_serve_restart_reads_back(tmp_path):
    data = tmp_path / "data"
    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 8)).astype(np.float32)
    s = Serve(tmp_path, data)
    try:
        assert requests.post(s.base + "/vector/actions/create", json={
            "index_name": "cli", "metric": "euclidean", "m": 8,
            "ef_construction": 32}).status_code == 200
        assert requests.post(s.base + "/vector/actions/create", json={
            "index_name": "clih", "kind": "host"}).status_code == 200
        for name in ("cli", "clih"):
            r = requests.post(s.base + "/vector/actions/add-batch", json={
                "index_name": name, "vectors": [
                    {"id": f"v{i}", "vector": X[i].tolist()}
                    for i in range(40)]})
            assert r.status_code == 200, r.text
            r = requests.post(s.base + "/vector/actions/search", json={
                "index_name": name, "query_vector": X[7].tolist(), "k": 1})
            assert r.json()["ids"] == ["v7"], r.text
    finally:
        s.stop()
    s = Serve(tmp_path, data)
    try:
        for name in ("cli", "clih"):
            r = requests.post(s.base + "/vector/actions/get-vectors", json={
                "index_name": name, "ids": [f"v{i}" for i in range(40)]})
            got = {v["id"]: v["vector"] for v in r.json()}
            assert len(got) == 40
            np.testing.assert_array_equal(
                np.array([got[f"v{i}"] for i in range(40)], np.float32), X)
    finally:
        s.stop()


def test_mcp_over_stdio(tmp_path):
    reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
             "params": {}},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
             "params": {"name": "save_memory",
                        "arguments": {"content": "the cat sat"}}},
            {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
             "params": {"name": "list_vectors", "arguments": {}}}]
    r = subprocess.run(
        _cli("mcp", "--device", "cpu", "--log-level", "warning"),
        input="".join(json.dumps(q) + "\n" for q in reqs), cwd=ROOT,
        env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = [json.loads(line) for line in r.stdout.splitlines()]
    assert [o["id"] for o in out] == [1, 2, 3, 4], r.stdout
    assert "serverInfo" in out[0]["result"]
    assert len(out[1]["result"]["tools"]) == 61
    saved = json.loads(out[2]["result"]["content"][0]["text"])
    listed = json.loads(out[3]["result"]["content"][0]["text"])
    assert listed["total"] == 1 and saved["id"] in listed["ids"], saved


@pytest.mark.parametrize("args,item", [
    (["tui"], "item 13"),
    (["--coordinator", "localhost:1234"], "item 12"),
    (["--num-processes", "2"], "item 12"),
    (["--process-id", "0"], "item 12"),
])
def test_unported_modes_refused(tmp_path, args, item):
    """Items 12 and 13 are ported: no mode is refused for them any more.
    What still stops here is the missing terminal (`tui` in a pipe) and an
    incomplete process group (one distributed flag alone)."""
    r = subprocess.run(_cli(*args, "--device", "cpu"), cwd=ROOT,
                       env=_env(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert item not in r.stderr and "not ported" not in r.stderr, r.stderr
    if args == ["tui"]:
        assert "curses" in r.stderr, r.stderr
    else:
        assert "a process group needs" in r.stderr, r.stderr


def test_default_device_needs_a_card(tmp_path):
    """Without a card and without `--device cpu`, the CLI refuses to start
    instead of running on the CPU unasked."""
    r = subprocess.run(_cli("mcp"), input="", cwd=ROOT, env=_env(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr, r.stderr
