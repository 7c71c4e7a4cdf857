"""Build and load the port's CUDA kernels (the sources in `csrc/`).

The kernels have a plain C interface, so they are compiled by `nvcc`
straight into a shared library and loaded with `ctypes`; nothing includes
PyTorch's headers, which keeps a cold build to seconds. The library is
built at first use into `build/kektordb_tpu_torch/<hash>/` beside the
package, keyed by a hash of the sources and the flags, so an edit to a
source rebuilds and an unchanged tree reuses the library.

There is no fallback: without `nvcc` a CUDA call raises. The CPU never
reaches this module (the wrappers take their plain PyTorch versions for
CPU tensors).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" \
    / "kektordb_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libkektor_kernels.so"

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from kektordb_tpu_torch/csrc at first use")


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless a library for
    these sources and flags exists; return its path. The compiler's
    output (ptxas register and shared-memory use) is kept beside it in
    build.log."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16]
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)          # atomic: a concurrent process never
    return lib                    # loads a half-written library


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.kektor_scan_pass_a
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = lib.kektor_gather_dist
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_long] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib
