"""Build and load the port's CUDA kernels (the sources in `csrc/`).

The kernels have a plain C interface, so they are compiled by `nvcc`
straight into a shared library and loaded with `ctypes`; nothing includes
PyTorch's headers, which keeps a cold build to seconds. Each source is
compiled to an object by its own `nvcc`, all started together, and the
objects are linked into the one library. The library is
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
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
    these sources and flags exists; return its path. One compiler per
    source runs at once, then one link. The compilers' output (ptxas
    register and shared-memory use) is kept beside the library in
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
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out / f"{src.stem}.{tag}.o" for src in sources]
    jobs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
    logs = [job.communicate()[0] for job in jobs]
    tmp = out / f"{LIB_NAME}.{tag}.tmp"
    failed = [src.name for src, job in zip(sources, jobs) if job.returncode]
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append("the link")
    (out / "build.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{''.join(logs)[-4000:]}")
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
            fn = lib.kektor_scan_vt
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = lib.kektor_gather_dist
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_long] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib
