"""The port's host runtime: the counterpart of the JAX package's
`kektordb_tpu/native/__init__.py`, bound to its own copy of the C++
source, `csrc/host/kektor_native.cpp`, with the JAX package's C entries
and public names (`crc32`, `scan_frames`, `bruteforce_topk`,
`arena_write`, `arena_read`), and one entry of the port's own:
`b64decode`, which decodes the batched search's base64 queries straight
from the request body (`server/http.py`).

The library is built by `g++` at first use into
`build/kektordb_tpu_torch/host/<hash>/` beside the package, keyed by a hash
of the source, the flags, the compiler's version and target, and the C
library's version, and loaded with `ctypes`. There is no fallback: without
`g++`, or when the build fails, a call raises with the compiler's output.
It is built without `-march`, so a library built on one x86-64 host runs on
any other.

Where the JAX package's scanner stops for good at its capacity (4,194,304
frames) and drops the rest of the journal, `scan_frames` resumes the C
scanner where it stopped until the buffer ends; it reports the offset of
every corrupt region, a torn tail shorter than a header included, as the
Python scanner `persist/aof.scan_frames` does. Buffers are passed by
pointer, not copied, and frames come back as numpy arrays.

Plain versions, which the tests hold the library to: `persist/aof.
scan_frames` for the scanner, `zlib.crc32` for `crc32`,
`bruteforce_topk_plain`, `arena_write_plain` / `arena_read_plain`, and
`base64.b64decode(..., validate=True)` for `b64decode`.

`ctypes.CDLL` releases the interpreter's lock for every call, so other
threads run Python while an entry runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "host" / "kektor_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" \
    / "kektordb_tpu_torch" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fopenmp-simd", "-shared", "-fPIC")
LIB_NAME = "libkektor_native.so"

L2, COSINE = "euclidean", "cosine"
FRAME_HEADER = 10            # magic, opcode, payload length, crc32
SCAN_CAP = 1 << 20           # frames (and corrupt regions) per C call
ARENA_MAGIC = 0x4B544E41     # "KTNA"
ARENA_HEADER = 64            # u32[16]: magic, version, dim, precision, rows

_lib = None
_lock = threading.Lock()

_P, _L, _I, _U = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_uint32
# C entry -> (result type, argument types); ctypes would otherwise pass
# every int as 32 bits and cut the pointers and the 64-bit sizes
SIGNATURES = {
    "kn_l2_batch": (None, [_P, _P, _L, _L, _P]),
    "kn_dot_batch": (None, [_P, _P, _L, _L, _P]),
    "kn_cosine_batch": (None, [_P, _P, _L, _L, _P]),
    "kn_dot_i8_batch": (None, [_P, _P, _L, _L, _P]),
    "kn_topk": (None, [_P, _L, _L, _P, _P]),
    "kn_bruteforce_topk": (None, [_P, _L, _P, _L, _L, _L, _I, _P, _P]),
    "kn_crc32": (_U, [_P, _L, _U]),
    "kn_scan_frames": (_L, [_P, _L, _L, _L] + [_P] * 6),
    "kn_arena_write": (_I, [ctypes.c_char_p, _P, _L, _L]),
    "kn_arena_read": (_I, [ctypes.c_char_p, _L, _L, _P, _P, _P]),
    "kn_b64_decode": (_L, [_P, _L, _P]),
}
_ARENA_ERRORS = {-1: "cannot open the file", -2: "bad header or magic",
                 -3: "rows beyond the file's", -4: "short read or write"}


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the host runtime is "
                           "built from kektordb_tpu_torch/csrc/host at "
                           "first use")
    return found


def build() -> Path:
    """Compile csrc/host/kektor_native.cpp unless a library for this
    source, these flags and this toolchain exists; return its path. The
    compiler's output is kept beside the library in build.log; a failed
    build raises with it."""
    cxx = _cxx()
    tool = subprocess.run([cxx, "-dumpfullversion", "-dumpmachine"],
                          capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for part in (tool, os.confstr("CS_GNU_LIBC_VERSION") or ""):
        h.update(part.encode())
    h.update(SRC.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16]
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       capture_output=True, text=True)
    log = r.stdout + r.stderr
    (out / "build.log").write_text(log)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{log[-4000:]}")
    os.replace(tmp, lib)          # atomic: a concurrent process never
    return lib                    # loads a half-written library


def load() -> ctypes.CDLL:
    """The loaded host library, built on first call, with the result and
    argument types of every entry set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (res, args) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------- crc32

def crc32(data, seed: int = 0) -> int:
    """zlib's CRC-32 of a bytes-like object, continued from `seed`."""
    view = np.frombuffer(data, np.uint8)
    return int(load().kn_crc32(_ptr(view), view.size, seed & 0xFFFFFFFF))


# ---------------------------------------------------------- frame scanner

class Frames(NamedTuple):
    """Every valid frame of a journal image, in order: payload offsets,
    payload lengths and opcodes; and the offset of each corrupt region."""
    offsets: np.ndarray      # int64
    lengths: np.ndarray      # int64
    opcodes: np.ndarray      # uint8
    corrupt: np.ndarray      # int64


def scan_frames(buf, _cap: int | None = None) -> Frames:
    """The frames of a journal image (bytes, bytearray, memoryview or
    mmap), found by the C scanner in calls of at most `_cap` (default
    SCAN_CAP) frames and corrupt regions each, each call resuming where
    the last stopped, so the result holds every frame, however many.
    `_cap` is for tests."""
    lib = load()
    view = np.frombuffer(buf, np.uint8)
    n = view.size
    cap = max(1, min(_cap or SCAN_CAP, n // FRAME_HEADER + 1))
    meta = np.zeros(2, np.int64)          # regions written, stop offset
    parts = []
    start = 0
    while start < n:
        offs, lens = np.empty(cap, np.int64), np.empty(cap, np.int64)
        ops, bad = np.empty(cap, np.uint8), np.empty(cap, np.int64)
        found = lib.kn_scan_frames(
            _ptr(view), n, start, cap, _ptr(offs), _ptr(lens), _ptr(ops),
            _ptr(bad), _ptr(meta), _ptr(meta) + 8)
        scan_frames.calls += 1
        parts.append((offs[:found], lens[:found], ops[:found],
                      bad[:int(meta[0])]))
        if meta[1] <= start:          # each call takes a frame or a region
            raise RuntimeError(f"kn_scan_frames stopped at {int(meta[1])} "
                               f"from {start} of {n} bytes")
        start = int(meta[1])
    if not parts:
        return Frames(np.empty(0, np.int64), np.empty(0, np.int64),
                      np.empty(0, np.uint8), np.empty(0, np.int64))
    return Frames(*(np.concatenate(p) for p in zip(*parts)))


scan_frames.calls = 0


# ----------------------------------------------------------- exact top-k

def _metric_code(metric: str) -> int:
    if metric not in (L2, COSINE):
        raise ValueError(f"metric must be {L2!r} or {COSINE!r}, not "
                         f"{metric!r}")
    return 0 if metric == L2 else 1


def _topk_args(queries, rows, k):
    q = np.ascontiguousarray(queries, np.float32)
    r = np.ascontiguousarray(rows, np.float32)
    if q.ndim != 2 or r.ndim != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"queries [B, D] and rows [N, D], not "
                         f"{q.shape} and {r.shape}")
    return q, r, min(k, max(r.shape[0], 1))


def bruteforce_topk(queries: np.ndarray, rows: np.ndarray, k: int,
                    metric: str = L2) -> tuple[np.ndarray, np.ndarray]:
    """The host's exact top-k: (distances [B, k] f32, rows [B, k] int32),
    ascending by (distance, row), k cut to the row count; squared L2, or
    cosine as 1 - dot of normalized vectors."""
    code = _metric_code(metric)
    q, r, k = _topk_args(queries, rows, k)
    idx = np.empty((q.shape[0], k), np.int32)
    dst = np.empty((q.shape[0], k), np.float32)
    load().kn_bruteforce_topk(_ptr(q), q.shape[0], _ptr(r), r.shape[0],
                              q.shape[1], k, code, _ptr(idx), _ptr(dst))
    return dst, idx


def bruteforce_topk_plain(queries: np.ndarray, rows: np.ndarray, k: int,
                          metric: str = L2
                          ) -> tuple[np.ndarray, np.ndarray]:
    """`bruteforce_topk` in numpy: f32 distances, a stable sort (ties by
    row), slots past the row count at row -1 and +inf."""
    code = _metric_code(metric)
    q, r, k = _topk_args(queries, rows, k)
    if code == 0:
        diff = q[:, None, :] - r[None, :, :]
        d = np.einsum("bnd,bnd->bn", diff, diff)
    else:
        d = np.float32(1.0) - q @ r.T
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    dst = np.full((q.shape[0], k), np.inf, np.float32)
    idx = np.full((q.shape[0], k), -1, np.int32)
    m = order.shape[1]
    dst[:, :m] = np.take_along_axis(d, order, 1)
    idx[:, :m] = order
    return dst, idx


# ----------------------------------------------------------- arena files

def arena_write(path, data: np.ndarray) -> None:
    """Write [rows, dim] f32 rows as a "KTNA" arena file."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError(f"arena rows are [rows, dim], not {data.shape}")
    rc = load().kn_arena_write(os.fsencode(path), _ptr(data),
                               data.shape[0], data.shape[1])
    if rc:
        raise OSError(f"arena write {path}: "
                      f"{_ARENA_ERRORS.get(rc, rc)} (rc {rc})")


def _row_range(path, rows: int, row_start: int, count: int) -> int:
    if count < 0:
        count = rows - row_start
    if row_start < 0 or count < 0 or row_start + count > rows:
        raise OSError(f"arena read {path}: rows [{row_start}, "
                      f"{row_start + count}) beyond the file's {rows}")
    return count


def arena_read(path, row_start: int = 0, count: int = -1) -> np.ndarray:
    """Rows [row_start, row_start + count) of an arena file (count < 0:
    to the end) as [count, dim] f32; OSError for a missing file, a bad
    magic, a short file or rows beyond the file's."""
    lib = load()
    meta = np.zeros(2, np.int64)                  # dim, rows
    name = os.fsencode(path)
    rc = lib.kn_arena_read(name, 0, 0, None, _ptr(meta), _ptr(meta) + 8)
    if rc:
        raise OSError(f"arena read {path}: "
                      f"{_ARENA_ERRORS.get(rc, rc)} (rc {rc})")
    dim, rows = int(meta[0]), int(meta[1])
    count = _row_range(path, rows, row_start, count)
    out = np.empty((count, dim), np.float32)
    if count:
        rc = lib.kn_arena_read(name, row_start, count, _ptr(out),
                               _ptr(meta), _ptr(meta) + 8)
        if rc:
            raise OSError(f"arena read {path}: "
                          f"{_ARENA_ERRORS.get(rc, rc)} (rc {rc})")
    return out


def arena_write_plain(path, data: np.ndarray) -> None:
    """`arena_write` in numpy."""
    data = np.ascontiguousarray(data, np.float32)
    header = np.zeros(ARENA_HEADER // 4, np.uint32)
    header[:3] = ARENA_MAGIC, 1, data.shape[1]
    header[4:6] = np.frombuffer(np.int64(data.shape[0]).tobytes(), np.uint32)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(data.tobytes())


def arena_read_plain(path, row_start: int = 0,
                     count: int = -1) -> np.ndarray:
    """`arena_read` in numpy."""
    with open(path, "rb") as f:
        head = f.read(ARENA_HEADER)
        header = np.frombuffer(head.ljust(ARENA_HEADER, b"\0"), np.uint32)
        if len(head) < ARENA_HEADER or header[0] != ARENA_MAGIC:
            raise OSError(f"arena read {path}: bad header or magic")
        dim = int(header[2])
        rows = int(np.frombuffer(header[4:6].tobytes(), np.int64)[0])
        count = _row_range(path, rows, row_start, count)
        f.seek(ARENA_HEADER + row_start * dim * 4)
        body = f.read(count * dim * 4)
    if len(body) != count * dim * 4:
        raise OSError(f"arena read {path}: short read")
    return np.frombuffer(body, np.float32).reshape(count, dim).copy()


# --------------------------------------------------------------- base64

def b64decode(buf, start: int = 0, end: int | None = None
              ) -> np.ndarray | None:
    """The bytes that buf[start:end] encodes in standard base64, as a
    uint8 array, read in place from `buf` (bytes-like); None where that
    span is not standard base64: a byte outside A-Z a-z 0-9 + /, '='
    anywhere but the last one or two places, or a length that is not a
    multiple of 4. The bits a padded quad leaves over are ignored, as
    `base64.b64decode` does."""
    view = np.frombuffer(buf, np.uint8)
    end = view.size if end is None else end
    if not 0 <= start <= end <= view.size:
        raise ValueError(f"span [{start}, {end}) outside a buffer of "
                         f"{view.size} bytes")
    out = np.empty((end - start) // 4 * 3, np.uint8)
    n = load().kn_b64_decode(_ptr(view) + start, end - start, _ptr(out))
    return None if n < 0 else out[:n]
