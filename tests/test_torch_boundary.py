"""The PyTorch port's import boundary and device rules.

The port must never import JAX or any module of the JAX package, not even
one that does not import JAX: on a GPU machine a JAX backend would start
and take the card's memory, and the port keeps its own copies of what it
needs. This test process imports JAX already (tests/conftest.py), so the
boundary is checked in a fresh interpreter that imports the server, the
services, the CLI and the host arena, and runs a filtered, a hybrid
(text_query), a decayed and a host-index search; a second one imports the
sharded and replicated serving modules, the client package and the MiniLM
encoder, and runs a sharded Engine search and an encoder forward; neither
JAX, ml_dtypes nor the JAX package may be loaded after either."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kektordb_tpu_torch import device as devlib
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index import BruteForceIndex, HNSWConfig, HNSWIndex
from kektordb_tpu_torch.index.hostarena import HostArenaIndex
from kektordb_tpu_torch.parallel import ShardedHNSW
from kektordb_tpu_torch.services.minilm import MiniLMEncoder

ROOT = Path(__file__).resolve().parent.parent

_CHILD = """
import sys
import numpy as np
import kektordb_tpu_torch.__main__
import kektordb_tpu_torch.server
import kektordb_tpu_torch.server.mcp
import kektordb_tpu_torch.services.embeddings
import kektordb_tpu_torch.services.gardener
import kektordb_tpu_torch.services.rag
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index.hostarena import HostArenaIndex
e = Engine(EngineConfig(device="cpu", start_background=False)).open()
e.create_index("i", kind="hnsw", serve_mode="scan")
X = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
e.add_batch("i", [f"v{j}" for j in range(300)], X,
            [{"even": str(j % 2 == 0)} for j in range(300)])
hits = e.search("i", X[:2], k=3, filter="even = True")
assert hits[0][0]["id"] == "v0", hits
e.add_batch("i", ["t0", "t1"], X[:2] + 5,
            [{"body": "red fox", "_indexed_fields": ["body"]},
             {"body": "blue whale", "_indexed_fields": ["body"]}])
hits = e.search("i", X[:1], k=3, text_query="whale", alpha=0.2)
assert hits[0][0]["id"] == "t1", hits
e.configure_index("i", {"memory": {"enabled": True,
                                   "decay_half_life": 3600.0}})
hits = e.search("i", X[:2], k=3)
assert hits[0][0]["id"] == "v0" and e.indexes["i"].decay_dev, hits
e.create_index("h", kind="host")
e.add_batch("h", [f"h{j}" for j in range(300)], X)
hits = e.search("h", X[5:7], k=2)
assert hits[0][0]["id"] == "h5" and hits[1][0]["id"] == "h6", hits
assert isinstance(e.indexes["h"].index, HostArenaIndex)
e.close()
"""

_LEAKS = """
import sys
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "kektordb_tpu", "ml_dtypes")
             or m.startswith(("jax.", "jaxlib.", "kektordb_tpu.",
                              "ml_dtypes.")))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""

_CHILD_NEW = """
import os
import numpy as np
os.environ["KEKTOR_TORCH_DEVICE_REPEAT"] = "2"
import kektordb_tpu_torch.client
import kektordb_tpu_torch.client.tui
import kektordb_tpu_torch.client.langchain
import kektordb_tpu_torch.distboot
import kektordb_tpu_torch.parallel
import kektordb_tpu_torch.services.download
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.parallel import ShardedHNSW
from kektordb_tpu_torch.services.minilm import MiniLMEncoder
e = Engine(EngineConfig(device="cpu", start_background=False)).open()
e.create_index("s", shards=2, serve_mode="scan")
X = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
e.add_batch("s", [f"v{j}" for j in range(100)], X)
assert isinstance(e.indexes["s"].index, ShardedHNSW)
assert e.search("s", X[3], k=1)[0][0]["id"] == "v3"
e.close()
p = MiniLMEncoder.random_params(vocab_size=16, dim=32, n_layers=1,
                                n_heads=4, intermediate=64, max_pos=16)
enc = MiniLMEncoder.from_params(
    p, lambda t: (np.ones((len(t), 4), np.int32),
                  np.ones((len(t), 4), np.float32)),
    n_layers=1, n_heads=4, dim=32, device="cpu")
assert enc.encode(["a", "b"]).shape == (2, 32)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_engine_search_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD + _LEAKS], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_parallel_client_minilm_import_no_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD_NEW + _LEAKS],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_chip_smoke_refuses_without_cuda():
    """No card: chip_smoke exits non-zero and prints no result line."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo
    cannot pass: the port is missing there."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = _env()
    env["PYTHONPATH"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("make", [
    lambda: HNSWIndex(8, config=HNSWConfig(serve_mode="scan")),
    lambda: BruteForceIndex(8),
    lambda: Engine(EngineConfig()),
    lambda: HostArenaIndex(8),
    lambda: ShardedHNSW(8),
    lambda: MiniLMEncoder.from_params({}, None, n_layers=0, n_heads=1,
                                      dim=8),
])
def test_cuda_default_raises_without_cuda(make, monkeypatch):
    """The default device is "cuda"; without a card it raises instead of
    running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make()


def test_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert devlib.resolve("cpu").type == "cpu"
