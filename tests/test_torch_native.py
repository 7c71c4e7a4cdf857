"""The port's host runtime (`kektordb_tpu_torch.host_native`, the C++
source `csrc/host/kektor_native.cpp`) against the JAX package's
`kektordb_tpu.native` and against the port's plain versions, on the CPU.

* `crc32` equals `zlib.crc32` and the reference's over lengths 0 to 4,097
  at unaligned starts, and continues from a seed.
* `scan_frames` finds the same frames as the port's Python scanner
  (`persist/aof.scan_frames`), the reference's Python scanner and its
  C++ one, and the same corrupt-region offsets as both Python scanners,
  on clean and corrupted journals; it resumes past its capacity where
  the reference's C++ scanner stops at its cap, and counts a torn tail
  shorter than a header as a corrupt region, which the reference's C++
  scanner misses.
* `read_frames`, and so the Engine's replay, run on the C++ scanner.
* `bruteforce_topk` against its numpy version, the reference's and the
  port's `ops/distance.brute_force_topk`, ties ordered by (distance, row).
* Arena files cross between the packages byte for byte; bad files raise.
* The distance entries bound directly, against numpy.
* `b64decode`, the port's own entry, against `base64.b64decode(...,
  validate=True)` on payloads of every length mod 3, inside a larger
  buffer too; every byte outside the standard alphabet, a misplaced `=`
  and a length that is not a multiple of 4 are refused.
* No fallback: without g++, or after a failed build, the library raises.
* The reference's first-use build loses its library to a concurrent
  writer for the rest of the process; the port's tests load a private
  build of it (`private_reference_native`), and the port's own build
  survives four processes building at once.
"""

import base64
import contextlib
import ctypes
import logging
import os
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import kektordb_tpu.native as jnative
from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu.persist import aof as jaof
from kektordb_tpu_torch import host_native as hn
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.ops import distance as dist
from kektordb_tpu_torch.persist import aof, resp

RTOL = 1e-5        # f32 distances summed in another order
REPO = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def private_reference_native(directory):
    """The JAX package's C++ library, built by its own `_build` (its flags,
    its source) into `directory` and loaded by this process alone, for the
    span of the block; yields the loaded library.

    The shared `kektor_native.so` beside the reference's source is never
    read: the reference builds it there at first use with no temporary
    name and no lock, and marks its load tried before the first attempt,
    so a process that opens it while another process writes it keeps the
    Python fallbacks for its whole life, or dies of SIGBUS."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", str(directory / "kektor_native.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert jnative.available(), \
            "the reference's kektor_native did not build"
        yield jnative.get_lib()


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's scanner, top-k and arena calls run on its C++
    library, not on their silent Python fallbacks."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


# ------------------------------------------------------------------ crc32

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32_equals_zlib_and_reference(seed):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, size=4097 + 8, dtype=np.uint8).tobytes()
    view = memoryview(buf)
    for n in range(4098):
        start = (n * 5 + seed) % 8             # unaligned starts
        piece = view[start:start + n]
        want = zlib.crc32(piece)
        got = hn.crc32(piece)
        assert got == want == jnative.crc32(bytes(piece)), (n, start)


@pytest.mark.parametrize("split", [0, 1, 7, 8, 9, 100, 333])
def test_crc32_continues_from_a_seed(split):
    data = np.random.default_rng(split).integers(
        0, 256, size=333, dtype=np.uint8).tobytes()
    head = hn.crc32(data[:split])
    assert hn.crc32(data[split:], head) == zlib.crc32(data) \
        == jnative.crc32(data[split:], head)


# ----------------------------------------------------------- frame scanner

def _journal(n=40, seed=0) -> bytes:
    """Journal frames of VADD commands whose vector bytes hold 0xA5
    often: false magic bytes inside payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vec = rng.integers(0, 256, size=int(rng.integers(0, 300)),
                           dtype=np.uint8)
        vec[::7] = 0xA5
        out.append(aof.encode_frame(resp.format_command(
            "VADD", "i", f"v{i}", vec.tobytes()), 1 + i % 3))
    return b"".join(out)


def _corrupt(buf: bytes, case: str) -> bytes:
    """The corruption cases of tests/test_torch_persist.py, and a torn tail
    shorter than a frame header."""
    b = bytearray(buf)
    n = len(b)
    if case == "zeros_mid":
        b[n // 2:n // 2 + 4] = b"\x00" * 4
    elif case == "bad_crc":
        b[n // 3] ^= 0xFF
    elif case == "torn_tail":
        del b[n - 5:]
    elif case == "garbage_head":
        b[0:0] = b"\xa5\x01garbage\xa5"
    elif case == "two_regions":
        b[n // 4:n // 4 + 9] = b"\xa5" * 9
        b[3 * n // 4] ^= 0x5A
    elif case == "all_garbage":
        b = bytearray(np.random.default_rng(1).integers(
            0, 256, size=2000, dtype=np.uint8).tobytes())
    elif case == "short_tail":
        b += b"\xa5\x01\x00"
    return bytes(b)


CASES = ("clean", "zeros_mid", "bad_crc", "torn_tail", "garbage_head",
         "two_regions", "all_garbage", "short_tail")


def _tuples(fr: hn.Frames) -> list[tuple[int, int, int]]:
    return list(zip(fr.offsets.tolist(), fr.lengths.tolist(),
                    fr.opcodes.tolist()))


def _reference_python_regions(buf: bytes, tmp_path, monkeypatch):
    """The reference's Python replay scanner's corrupt offsets: its
    read_frames with its C++ library hidden."""
    p = tmp_path / "ref.aof"
    p.write_bytes(buf)
    hits = []
    with monkeypatch.context() as m:
        m.setattr(jnative, "available", lambda: False)
        payloads = [pl for _, pl in jaof.read_frames(str(p), hits.append)]
    return hits, payloads


@pytest.mark.parametrize("case", CASES)
def test_scan_frames_equals_python_scanners(case, tmp_path, monkeypatch):
    buf = _corrupt(_journal(), case)
    got = hn.scan_frames(buf)
    frames, corrupt = aof.scan_frames(buf)
    ref_py, ref_count = jnative._scan_frames_py(buf)
    ref_regions, ref_payloads = _reference_python_regions(
        buf, tmp_path, monkeypatch)
    ref_cpp, _ = jnative.scan_frames(buf)
    assert _tuples(got) == frames == ref_py == \
        [tuple(map(int, f)) for f in ref_cpp]
    assert got.corrupt.tolist() == corrupt == ref_regions
    assert len(corrupt) == ref_count
    assert (case == "clean") == (not corrupt)
    assert [buf[o:o + n] for o, n, _ in frames] == ref_payloads
    assert got.offsets.dtype == np.int64 and got.opcodes.dtype == np.uint8


def test_short_torn_tail_is_a_region_the_reference_cpp_misses():
    """A torn tail shorter than a frame header: the port counts a corrupt
    region, as both Python scanners do; the reference's C++ loop runs
    while a whole header fits, so it reports none."""
    buf = _corrupt(_journal(49), "short_tail")
    got = hn.scan_frames(buf)
    assert got.corrupt.tolist() == [len(buf) - 3]
    assert len(got.offsets) == 49
    assert jnative._scan_frames_py(buf)[1] == 1
    ref_frames, ref_corrupt = jnative.scan_frames(buf)
    assert len(ref_frames) == 49 and ref_corrupt == 0


@pytest.mark.parametrize("cap", [1, 2, 3, 4, 7])
def test_scan_resumes_past_capacity_where_reference_stops_at_cap(cap):
    """Capacity 4 (and others) over 12 frames with corrupt regions across
    the boundaries: the port returns every frame and region, the
    reference's C++ scanner only its cap of frames."""
    buf = bytearray(_journal(12, seed=3))
    frames, _ = aof.scan_frames(bytes(buf))
    for at in (2, 4, 8):                       # inside frames 2, 4, 8
        buf[frames[at][0] + 1] ^= 0xFF
    buf = bytes(buf)
    want, regions = aof.scan_frames(buf)
    assert len(want) == 9 and len(regions) == 3
    calls = hn.scan_frames.calls
    got = hn.scan_frames(buf, _cap=cap)
    assert _tuples(got) == want and got.corrupt.tolist() == regions
    assert hn.scan_frames.calls - calls > 1
    ref, _ = jnative.scan_frames(buf, max_frames=cap)
    assert len(ref) == cap < len(want)


@pytest.mark.parametrize("seed", range(8))
def test_scan_random_corruption_any_capacity(seed):
    rng = np.random.default_rng(100 + seed)
    buf = bytearray(_journal(30, seed=seed))
    for _ in range(int(rng.integers(1, 6))):
        at = int(rng.integers(0, len(buf)))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            buf[at] ^= int(rng.integers(1, 256))
        elif kind == 1:
            del buf[at:at + int(rng.integers(1, 40))]
        else:
            buf[at:at] = b"\xa5" * int(rng.integers(1, 12))
    buf = bytes(buf)
    want, regions = aof.scan_frames(buf)
    for cap in (None, 1, int(rng.integers(2, 9))):
        got = hn.scan_frames(buf, _cap=cap)
        assert _tuples(got) == want and got.corrupt.tolist() == regions


def test_scan_takes_buffers_without_copying():
    buf = _journal(20)
    want = aof.scan_frames(buf)
    for b in (bytearray(buf), memoryview(buf), b""):
        got = hn.scan_frames(b)
        exp = want if len(b) else ([], [])
        assert (_tuples(got), got.corrupt.tolist()) == (exp[0], exp[1])


def test_read_frames_runs_on_cpp_scanner(tmp_path, monkeypatch):
    """read_frames scans with host_native at any capacity and reports each
    corrupt region's offset, as the reference's Python replay does."""
    buf = _corrupt(_journal(), "two_regions") + b"\xa5"
    p = tmp_path / "j.aof"
    p.write_bytes(buf)
    monkeypatch.setattr(hn, "SCAN_CAP", 3)
    calls = hn.scan_frames.calls
    hits = []
    got = list(aof.read_frames(str(p), hits.append))
    assert hn.scan_frames.calls - calls > 1
    ref_regions, ref_payloads = _reference_python_regions(
        buf, tmp_path, monkeypatch)
    assert [pl for _, pl in got] == ref_payloads
    assert hits == ref_regions and len(hits) == 3
    assert [op for op, _ in got] == [op for _, _, op in
                                     aof.scan_frames(buf)[0]]


def test_replay_past_scan_capacity_matches_reference(tmp_path, monkeypatch):
    """The slice end to end: a port Engine journals single adds, deletes
    and KV sets, crashes, and a zeroed stretch hits the journal's middle;
    reopened with a scanner capacity of 2, the port keeps every frame
    outside the corrupt region, as the reference's Engine does."""
    X = np.random.default_rng(5).normal(size=(40, 8)).astype(np.float32)
    e = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                            start_background=False)).open()
    e.create_index("i", kind="flat")
    for j in range(40):
        e.add("i", f"v{j}", X[j])
        e.kv_set(f"k{j}", f"{j}".encode())
    for j in range(0, 40, 9):
        e.delete("i", f"v{j}")
    e._aof.flush(fsync=True)
    e._aof.close()
    path = tmp_path / "journal.aof"
    buf = bytearray(path.read_bytes())
    # the zeroed stretch starts in the KV frame nearest the middle, so
    # that a KV pair is lost whatever the other frames' lengths
    fr = hn.scan_frames(bytes(buf))
    mid = min((int(o) for o, n in zip(fr.offsets, fr.lengths)
               if b"SET" in buf[o:o + n]),
              key=lambda o: abs(o - len(buf) // 2))
    buf[mid:mid + 6] = b"\x00" * 6
    path.write_bytes(bytes(buf))
    monkeypatch.setattr(hn, "SCAN_CAP", 2)
    calls = hn.scan_frames.calls
    p = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                            start_background=False)).open()
    assert hn.scan_frames.calls - calls > 1
    r = JEngine(JEngineConfig(data_dir=str(tmp_path),
                              start_background=False)).open()
    try:
        pids = sorted(p.indexes["i"].index.ids.ext_to_row)
        rids = sorted(r.indexes["i"].index.ids.ext_to_row)
        assert pids == rids and 25 < len(pids) < 36
        live = [int(e[1:]) for e in pids]
        for eng in (p, r):
            hits = eng.search("i", X[live], k=1)
            assert [h[0]["id"] for h in hits] == pids
            assert all(abs(h[0]["distance"]) < 1e-4 for h in hits)
        pk = {f"k{j}": p.kv_get(f"k{j}") for j in range(40)}
        assert pk == {f"k{j}": r.kv_get(f"k{j}") for j in range(40)}
        assert sum(v is None for v in pk.values()) >= 1
    finally:
        for eng in (p, r):
            eng._aof.close()


# ------------------------------------------------------------ exact top-k

def _rows(n=300, d=24, seed=0, metric=hn.L2):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(16, d)).astype(np.float32)
    if n >= 200:
        rows[150:200] = rows[:50]                   # exact duplicates: ties
        q[:4] = rows[[3, 20, 160, 49]]              # ties at the top
    if metric == hn.COSINE:
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, rows


def _same_topk(da, ia, db, ib):
    """Distances within RTOL of their magnitude (+1); ids equal except
    where a neighbouring distance ties within that tolerance."""
    assert da.shape == db.shape and ia.shape == ib.shape
    fin = np.isfinite(da)
    assert np.array_equal(fin, np.isfinite(db))
    tol = RTOL * (np.abs(np.where(fin, da, 0)) + 1.0)
    assert np.all(np.abs(np.where(fin, da - db, 0)) <= tol)
    for b, j in zip(*np.nonzero(ia != ib)):
        near = [i for i in (j - 1, j + 1) if 0 <= i < da.shape[1]
                and abs(da[b, i] - da[b, j]) <= tol[b, j]]
        assert near, (b, j, ia[b], ib[b])


def _ties_by_row(d, i):
    """Among bitwise-equal distances of one query, rows ascend."""
    for b in range(d.shape[0]):
        for j in range(1, d.shape[1]):
            if d[b, j] == d[b, j - 1] and i[b, j] >= 0:
                assert i[b, j] > i[b, j - 1], (b, j, i[b])


@pytest.mark.parametrize("k", [1, 10, 400])
@pytest.mark.parametrize("metric", [hn.L2, hn.COSINE])
def test_bruteforce_topk_matches_reference_and_plain(metric, k):
    q, rows = _rows(metric=metric)
    d, i = hn.bruteforce_topk(q, rows, k, metric)
    kk = min(k, len(rows))
    assert d.shape == i.shape == (len(q), kk) and i.dtype == np.int32
    _ties_by_row(d, i)
    pd, pi = hn.bruteforce_topk_plain(q, rows, k, metric)
    _same_topk(d, i, pd, pi)
    _ties_by_row(pd, pi)
    jd, ji = jnative.bruteforce_topk(q, rows, k, metric)
    _same_topk(d, i, jd, ji)
    td, ti = dist.brute_force_topk(torch.from_numpy(q),
                                   torch.from_numpy(rows), kk, metric)
    _same_topk(d, i, td.numpy(), ti.numpy())
    # duplicated rows: the lower row first
    assert i[0, 0] == pi[0, 0] == 3 and i[2, 0] == pi[2, 0] == 10
    if kk > 1:
        assert i[0, 1] == pi[0, 1] == 153 and i[2, 1] == pi[2, 1] == 160


def test_bruteforce_topk_edges():
    q, rows = _rows(n=5, d=4)
    d, i = hn.bruteforce_topk(q, rows[:0], 3)
    assert i.shape == (16, 1) and (i == -1).all() and np.isinf(d).all()
    pd, pi = hn.bruteforce_topk_plain(q, rows[:0], 3)
    assert np.array_equal(i, pi) and np.isinf(pd).all()
    with pytest.raises(ValueError, match="metric"):
        hn.bruteforce_topk(q, rows, 3, "dot")
    with pytest.raises(ValueError, match=r"\[B, D\]"):
        hn.bruteforce_topk(q, rows[:, :3], 3)


# ------------------------------------------------------------ arena files

WRITERS = {"port": hn.arena_write, "plain": hn.arena_write_plain,
           "reference": jnative.arena_write}
READERS = {"port": hn.arena_read, "plain": hn.arena_read_plain}


@pytest.mark.parametrize("reader", list(READERS))
@pytest.mark.parametrize("writer", list(WRITERS))
def test_arena_files_cross_packages(writer, reader, tmp_path):
    X = np.random.default_rng(2).normal(size=(37, 13)).astype(np.float32)
    p = str(tmp_path / "a.ktna")
    WRITERS[writer](p, X)
    read = READERS[reader]
    assert np.array_equal(read(p), X)
    assert np.array_equal(read(p, 5, 11), X[5:16])
    assert np.array_equal(read(p, 30), X[30:])
    assert read(p, 37).shape == (0, 13)
    assert np.array_equal(jnative.arena_read(p, 4, 9), X[4:13])
    ref = str(tmp_path / "ref.ktna")
    jnative.arena_write(ref, X)
    with open(p, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("reader", list(READERS))
def test_arena_bad_files_raise(reader, tmp_path):
    X = np.ones((4, 3), np.float32)
    p = tmp_path / "a.ktna"
    hn.arena_write(str(p), X)
    read = READERS[reader]
    for start, count in ((3, 2), (5, -1), (-1, 2), (0, 5)):
        with pytest.raises(OSError, match="beyond"):
            read(str(p), start, count)
    raw = bytearray(p.read_bytes())
    (tmp_path / "short.ktna").write_bytes(bytes(raw[:-4]))
    with pytest.raises(OSError):
        read(str(tmp_path / "short.ktna"), 0, 4)
    raw[0] ^= 1
    (tmp_path / "bad.ktna").write_bytes(bytes(raw))
    with pytest.raises(OSError, match="magic"):
        read(str(tmp_path / "bad.ktna"))
    (tmp_path / "tiny.ktna").write_bytes(b"KTNA")
    with pytest.raises(OSError, match="magic"):
        read(str(tmp_path / "tiny.ktna"))
    with pytest.raises(OSError):
        read(str(tmp_path / "none.ktna"))


def test_arena_write_raises_on_an_unwritable_path(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        hn.arena_write(str(tmp_path / "no" / "dir.ktna"),
                       np.ones((2, 2), np.float32))
    with pytest.raises(ValueError):
        hn.arena_write(str(tmp_path / "a.ktna"), np.ones(3, np.float32))


# ---------------------------------------------------------------- base64

B64_ALPHABET = frozenset(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                         b"0123456789+/")
B64_CASES = (
    [("payload", n) for n in (0, 1, 2, 3, 4, 5, 6, 47, 48, 49, 4097, 12288)]
    + [("inside", n) for n in (0, 7, 3 * 4096 + 2)]
    + [("bytes outside the alphabet", None),
       ("misplaced =", [b"=QUJD", b"Q=JD", b"QU=D", b"QQ=A", b"====",
                        b"Q===", b"QQ==QUJD", b"QUJD=QUJ", b"QQ===AAA"]),
       ("length", [b"Q", b"QU", b"QUJ", b"QUJDR", b"QQ=", b"QUJD=",
                   b"QUJDQQ=", b"QUJDQUJDQ"])])


@pytest.mark.parametrize("kind, arg", B64_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(B64_CASES)])
def test_b64decode_equals_python_and_refuses_the_rest(kind, arg):
    if kind == "payload":       # 0, 1 or 2 padding characters by n % 3
        data = np.random.default_rng(arg).integers(
            0, 256, arg, np.uint8).tobytes()
        text = base64.b64encode(data)
        assert text.count(b"=") == (3 - arg % 3) % 3
        out = hn.b64decode(text)
        assert out.dtype == np.uint8
        assert out.tobytes() == base64.b64decode(text, validate=True)
        return
    if kind == "inside":        # a span of a larger buffer, read in place
        data = np.random.default_rng(arg).integers(
            0, 256, arg, np.uint8).tobytes()
        text = base64.b64encode(data)
        buf = b'{"q": "' + text + b'"}'
        out = hn.b64decode(buf, 7, 7 + len(text))
        assert out.tobytes() == data
        assert hn.b64decode(buf) is None
        with pytest.raises(ValueError):
            hn.b64decode(buf, 7, len(buf) + 1)
        return
    if kind == "bytes outside the alphabet":
        # each byte at each place of a whole quad and of the padded tail
        good = bytearray(b"QUJDREVGRw==")
        assert hn.b64decode(bytes(good)).tobytes() == b"ABCDEFG"
        refused = 0
        for byte in set(range(256)) - B64_ALPHABET - {ord("=")}:
            for at in (0, 1, 2, 3, 8, 9):
                text = bytearray(good)
                text[at] = byte
                assert hn.b64decode(bytes(text)) is None, (byte, at)
                refused += 1
        assert refused == 191 * 6
        return
    for text in arg:            # misplaced '=', or a length not 4k
        assert hn.b64decode(text) is None, text


# ------------------------------------------------ the entries bound directly

def _call(name, q, rows, out):
    getattr(hn.load(), name)(q.ctypes.data, rows.ctypes.data, rows.shape[0],
                             rows.shape[1], out.ctypes.data)
    return out


@pytest.mark.parametrize("name", ["kn_l2_batch", "kn_dot_batch",
                                  "kn_cosine_batch", "kn_dot_i8_batch"])
@pytest.mark.parametrize("d", [1, 7, 64, 131])
def test_distance_entries_match_numpy(name, d):
    rng = np.random.default_rng(d)
    n = 50
    if name == "kn_dot_i8_batch":
        q = rng.integers(-128, 128, size=d, dtype=np.int8)
        rows = rng.integers(-128, 128, size=(n, d), dtype=np.int8)
        got = _call(name, q, rows, np.empty(n, np.int32))
        want = rows.astype(np.int64) @ q.astype(np.int64)
        assert np.array_equal(got, want)
        return
    q = rng.normal(size=d).astype(np.float32)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    got = _call(name, q, rows, np.empty(n, np.float32))
    q64, r64 = q.astype(np.float64), rows.astype(np.float64)
    want = {"kn_l2_batch": ((r64 - q64) ** 2).sum(1),
            "kn_dot_batch": r64 @ q64,
            "kn_cosine_batch": 1.0 - r64 @ q64}[name]
    scale = (np.abs(r64) * np.abs(q64)).sum(1) + 1.0
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


def test_topk_entry_keeps_the_lower_row_on_ties():
    dists = np.array([3, 1, 2, 1, 0, 2, 1], np.float32)
    idx, dst = np.empty(5, np.int32), np.empty(5, np.float32)
    hn.load().kn_topk(dists.ctypes.data, 7, 5, idx.ctypes.data,
                      dst.ctypes.data)
    assert idx.tolist() == [4, 1, 3, 6, 2]
    assert dst.tolist() == [0, 1, 1, 1, 2]
    idx, dst = np.empty(9, np.int32), np.empty(9, np.float32)
    hn.load().kn_topk(dists.ctypes.data, 7, 9, idx.ctypes.data,
                      dst.ctypes.data)
    assert idx.tolist()[7:] == [-1, -1] and np.isinf(dst[7:]).all()


def test_topk_entry_at_k0_writes_nothing():
    """k = 0 reads no heap top (the reference's loop compares against the
    top of an empty heap) and writes no slot."""
    dists = np.array([3, 1, 2], np.float32)
    idx = np.full(2, 77, np.int32)
    dst = np.full(2, 7.5, np.float32)
    hn.load().kn_topk(dists.ctypes.data, 3, 0, idx.ctypes.data,
                      dst.ctypes.data)
    assert idx.tolist() == [77, 77] and dst.tolist() == [7.5, 7.5]


@pytest.mark.parametrize("metric", [hn.L2, hn.COSINE])
def test_bruteforce_topk_at_k0(metric):
    q, rows = _rows(metric=metric)
    d, i = hn.bruteforce_topk(q, rows, 0, metric)
    pd, pi = hn.bruteforce_topk_plain(q, rows, 0, metric)
    assert d.shape == i.shape == pd.shape == pi.shape == (len(q), 0)
    assert (d.dtype, i.dtype) == (pd.dtype, pi.dtype) == (np.float32,
                                                           np.int32)


def test_every_entry_is_typed():
    lib = hn.load()
    # a CDLL, not a PyDLL: every call releases the interpreter's lock
    assert type(lib) is ctypes.CDLL
    for name, (res, args) in hn.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == args and fn.restype == res
        # sizes and offsets are 64-bit: a C int only for the metric code
        ints = [j for j, a in enumerate(args) if a is ctypes.c_int]
        assert ints == ([6] if name == "kn_bruteforce_topk" else [])


# ------------------------------------------------------------- no fallback

def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(hn, "_lib", None)
    monkeypatch.setattr(hn, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        hn.crc32(b"x")
    (tmp_path / "j.aof").write_bytes(_journal(3))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        list(aof.read_frames(str(tmp_path / "j.aof")))
    assert hn._lib is None


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "kektor_native.cpp"
    bad.write_text("extern \"C\" int kn_crc32( {\n")
    monkeypatch.setattr(hn, "_lib", None)
    monkeypatch.setattr(hn, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(hn, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        hn.load()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*/" + hn.LIB_NAME))
    assert list((tmp_path / "build").glob("*/build.log"))


# ------------------------------------------------------- first-use builds

def test_reference_load_is_lost_to_a_half_written_library(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    """The reference's library as a process finds it while another
    process's g++ is still writing it: an empty `kektor_native.so`, newer
    than its source, fails to load, and the reference never tries again
    (`_tried` is set before the first attempt), so the process keeps the
    Python fallbacks. A truncated ELF would kill the process with SIGBUS
    instead. `private_reference_native` still loads the C++ library on
    the same process state."""
    src = tmp_path / "kektor_native.cpp"
    shutil.copyfile(jnative._SRC, src)
    so = tmp_path / "kektor_native.so"
    so.write_bytes(b"")
    later = src.stat().st_mtime + 10
    os.utime(so, (later, later))
    for name, value in (("_SRC", str(src)), ("_SO", str(so)),
                        ("_lib", None), ("_tried", False)):
        monkeypatch.setattr(jnative, name, value)
    buf = _corrupt(_journal(49), "short_tail")
    with caplog.at_level(logging.WARNING, logger="kektordb.native"):
        assert not jnative.available()
    assert "native load failed" in caplog.text
    assert not jnative.available() and jnative._tried
    assert so.stat().st_size == 0                  # never rebuilt
    assert jnative.scan_frames(buf)[1] == 1        # the Python scanner's
    private = tmp_path / "private"
    with private_reference_native(private) as lib:
        assert jnative.get_lib() is lib
        assert lib._name == str(private / "kektor_native.so")
        assert jnative.scan_frames(buf)[1] == 0    # the C++ loop's
    assert not jnative.available()                 # poisoned again


# a g++ that writes its output in two halves; the first call to get to the
# second half waits there until the test lets it go on
_SLOW_GXX = """#!%(python)s
import os, subprocess, sys, time
args = sys.argv[1:]
if "-o" not in args:
    os.execv(%(gxx)r, [%(gxx)r] + args)
out = args[args.index("-o") + 1]
obj = os.path.join(%(gate)r, "obj.%%d" %% os.getpid())
args[args.index("-o") + 1] = obj
rc = subprocess.run([%(gxx)r] + args).returncode
if rc:
    sys.exit(rc)
data = open(obj, "rb").read()
os.unlink(obj)
with open(out, "wb") as f:
    f.write(data[:len(data) // 2])
try:
    os.close(os.open(os.path.join(%(gate)r, "paused"),
                     os.O_CREAT | os.O_EXCL))
    deadline = time.monotonic() + 60
    while not os.path.exists(os.path.join(%(gate)r, "resume")) \\
            and time.monotonic() < deadline:
        time.sleep(0.01)
except FileExistsError:
    pass
with open(out, "ab") as f:
    f.write(data[len(data) // 2:])
"""

_BUILD_CHILD = """
import sys
from pathlib import Path
from kektordb_tpu_torch import host_native as hn
hn.BUILD_ROOT = Path(sys.argv[1])
print(hn.crc32(b"kektor"))
"""


def test_port_builds_survive_concurrent_first_use(tmp_path):
    """Four processes build the host library into one empty build root:
    the first holds half of its compiler's output on disk while the other
    three start at once, find no library, and build and load their own.
    Each gets the library, one file comes out, and no temporary is left.
    This is the output under a temporary name, renamed into place with
    `os.replace` (`host_native.build`), which the reference's build
    lacks: a process that loads a half-written library fails or dies.
    `native.py`'s CUDA build uses the same pattern but needs nvcc, so it
    is not run here."""
    gate, bindir, root = (tmp_path / d for d in ("gate", "bin", "build"))
    gate.mkdir()
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text(_SLOW_GXX % {"python": sys.executable, "gate": str(gate),
                                "gxx": shutil.which("g++")})
    gxx.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")

    def start():
        return subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                                 str(root)], cwd=REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [start()]
    try:
        deadline = time.monotonic() + 60
        while not (gate / "paused").exists() and procs[0].poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert (gate / "paused").exists(), \
            f"the first build never paused (rc {procs[0].poll()})"
        procs += [start() for _ in range(3)]
        outs = [p.communicate(timeout=120) for p in procs[1:]]
        (gate / "resume").touch()
        outs.insert(0, procs[0].communicate(timeout=120))
    finally:
        (gate / "resume").touch()
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [str(zlib.crc32(b"kektor"))]
    (out_dir,) = root.iterdir()
    assert sorted(f.name for f in out_dir.iterdir()) == \
        ["build.log", hn.LIB_NAME]
