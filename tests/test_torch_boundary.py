"""The PyTorch port's import boundary and device rules.

The port must never import JAX or the JAX package's device modules: on a
GPU machine a JAX backend would start and take the card's memory. This
test process imports JAX already (tests/conftest.py), so the boundary is
checked in a fresh interpreter."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kektordb_tpu_torch import device as devlib
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.index import BruteForceIndex, HNSWConfig, HNSWIndex

ROOT = Path(__file__).resolve().parent.parent

_CHILD = """
import sys
import numpy as np
from kektordb_tpu_torch.engine import Engine, EngineConfig
e = Engine(EngineConfig(device="cpu", start_background=False)).open()
e.create_index("i", kind="hnsw", serve_mode="scan")
X = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
e.add_batch("i", [f"v{j}" for j in range(300)], X,
            [{"even": str(j % 2 == 0)} for j in range(300)])
hits = e.search("i", X[:2], k=3, filter="even = True")
assert hits[0][0]["id"] == "v0", hits
e.close()
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib") or m.startswith(
                 ("jax.", "jaxlib.", "kektordb_tpu.ops", "kektordb_tpu.index",
                  "kektordb_tpu.engine", "kektordb_tpu.parallel",
                  "kektordb_tpu.server", "kektordb_tpu.distboot")))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_engine_search_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
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
