"""The port's persistence codecs against the JAX package's.

* RESP commands and AOF frames are the same bytes, and parse back the
  same.
* `aof.read_frames` / `scan_frames` find the same frames as both of the
  reference's scanners (its C++ `kn_scan_frames`, from a build private
  to this module, and its Python one) on clean and corrupted journals,
  and the same count of corrupt regions as its Python scanner.
* The lazy writer's shadow buffer and its inline flush at BUFFER_CAP.
* Checkpoints: a generation written by either package loads in the other
  with every array bit-equal, bf16 under "<k>::bf16" (and a raw 2-byte
  void array read back as bf16); msgpack state bytes equal the
  reference's; a torn generation falls back to the older one.
"""

import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_native import private_reference_native

from kektordb_tpu.native import _scan_frames_py as j_scan_py
from kektordb_tpu.native import scan_frames as j_scan
from kektordb_tpu.persist import aof as jaof
from kektordb_tpu.persist import checkpoint as jckpt
from kektordb_tpu.persist import resp as jresp
from kektordb_tpu_torch.persist import aof, checkpoint, resp

PARTS = [
    [b"VADD", b"idx", b"id1", bytes(range(256)), b""],
    ["SET", "kéy", b"\r\n$3\r\n*2"],
    ["VCONFIG", "i", '{"serve_proj_dim": 8}'],
    [b""],
    [],
]


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """`j_scan` is the reference's C++ scanner, not its Python fallback."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


@pytest.mark.parametrize("parts", PARTS, ids=[f"cmd{i}" for i in
                                              range(len(PARTS))])
def test_resp_and_frame_bytes_equal_reference(parts):
    enc = resp.format_command(*parts)
    assert enc == jresp.format_command(*parts)
    assert resp.parse_command(enc) == jresp.parse_command(enc)
    for op in (aof.OP_COMMAND, 7):
        fr = aof.encode_frame(enc, op)
        assert fr == jaof.encode_frame(enc, op)
        assert aof.decode_frame(fr, 0) == jaof.decode_frame(fr, 0)


def test_resp_malformed_raises_like_reference():
    for bad in (b"+OK\r\n", b"*2\r\n$3\r\nabc\r\n$5\r\nxy\r\n",
                b"*x\r\n", b"*1\r\n$3\r\nabcXY"):
        with pytest.raises(resp.RESPError):
            resp.parse_command(bad)
        with pytest.raises(jresp.RESPError):
            jresp.parse_command(bad)


def _journal(n=40, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        # vector bytes hold 0xA5 often: false magic bytes inside payloads
        vec = rng.integers(0, 256, size=int(rng.integers(0, 300)),
                           dtype=np.uint8)
        vec[::7] = 0xA5
        out.append(aof.encode_frame(resp.format_command(
            "VADD", "i", f"v{i}", vec.tobytes()), 1 + i % 3))
    return b"".join(out)


def _corrupt(buf: bytes, case: str) -> bytes:
    b = bytearray(buf)
    n = len(b)
    if case == "clean":
        return bytes(b)
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
    return bytes(b)


CASES = ("clean", "zeros_mid", "bad_crc", "torn_tail", "garbage_head",
         "two_regions", "all_garbage")


@pytest.mark.parametrize("case", CASES)
def test_read_frames_equals_reference(tmp_path, case):
    buf = _corrupt(_journal(), case)
    p = str(tmp_path / "j.aof")
    with open(p, "wb") as f:
        f.write(buf)
    frames, corrupt = aof.scan_frames(buf)
    ref_native, _ = j_scan(buf)
    ref_py, ref_corrupt = j_scan_py(buf)
    assert frames == ref_py == [tuple(map(int, f)) for f in ref_native]
    assert len(corrupt) == ref_corrupt
    assert (case == "clean") == (not corrupt)
    hits, jhits = [], []
    got = list(aof.read_frames(p, hits.append))
    assert got == list(jaof.read_frames(p, jhits.append))
    assert hits == corrupt and bool(hits) == bool(jhits)
    assert list(aof.read_frames(str(tmp_path / "none.aof"))) == []


def test_lazy_writer_shadow_buffer_and_cap_flush(tmp_path):
    p = str(tmp_path / "l.aof")
    w = aof.LazyAOFWriter(p)
    w.write(b"before")
    w.begin_snapshot_mode()
    assert os.path.getsize(p) > 0         # flushed before the snapshot
    w.write(b"during")                    # diverted to the shadow
    w.truncate()
    assert os.path.getsize(p) == 0
    w.write_raw_frames(w.end_snapshot_mode())
    w.write(b"after")
    w.close()
    assert [pl for _, pl in aof.read_frames(p)] == [b"during", b"after"]
    assert [pl for _, pl in jaof.read_frames(p)] == [b"during", b"after"]

    p = str(tmp_path / "c.aof")
    w = aof.LazyAOFWriter(p)
    w.FLUSH_INTERVAL = 3600.0     # only the cap can flush before close
    for i in range(aof.LazyAOFWriter.BUFFER_CAP + 5):
        w.write(b"x%d" % i)
    assert len(list(aof.read_frames(p))) >= aof.LazyAOFWriter.BUFFER_CAP
    w.close()
    assert [pl for _, pl in aof.read_frames(p)] == \
        [b"x%d" % i for i in range(aof.LazyAOFWriter.BUFFER_CAP + 5)]


def _arrays(rng):
    f = rng.normal(size=(9, 5)).astype(np.float32)
    return {
        "i/vectors": f,
        "i/bf": f.astype(ml_dtypes.bfloat16),
        "i/codes": rng.integers(-127, 128, size=(9, 5), dtype=np.int8),
        "i/nbrs": rng.integers(-1, 9, size=(9, 4), dtype=np.int32),
        "i/deleted": rng.random(9) < 0.3,
        "i/entry": np.array(3, np.int32),
        "f/valid": np.ones(0, bool),
    }


STATE = {"version": 1, "kv": {"a": b"\x00\xff", "b": b""},
         "indexes": {"i": {"ext_to_row": {"x": 0, "y": 7}, "free": [3, 1],
                           "deleted_rows": {4, 5}, "pair": (1, 2.5),
                           "n": np.int64(7), "f": np.float32(0.25),
                           "none": None, "t": True}},
         "metadata": {0: {"k": [1, "two", {"three": 3.0}]}}}


def _same(port_t: torch.Tensor, ref: np.ndarray):
    if ref.dtype == ml_dtypes.bfloat16:
        assert port_t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            port_t.view(torch.int16).numpy(), ref.view(np.int16))
    else:
        assert port_t.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(port_t.numpy(), ref)


def test_checkpoint_round_trips_both_ways(tmp_path):
    arr = _arrays(np.random.default_rng(0))
    assert checkpoint.pack_state(STATE) == jckpt.msgpack.packb(
        STATE, default=jckpt._pack_default, use_bin_type=True)
    # the reference writes, the port reads
    jckpt.save(str(tmp_path / "ref"), arr, STATE)
    got, st = checkpoint.load(str(tmp_path / "ref"))
    assert set(got) == set(arr)
    for k in arr:
        _same(got[k], arr[k])
    _, jst = jckpt.load(str(tmp_path / "ref"))
    assert st == jst
    # the port writes (tensors, bf16 among them), the reference reads
    tens = {k: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a))
            for k, a in arr.items()}
    path = checkpoint.save(str(tmp_path / "port"), tens, STATE)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert "i/bf::bf16" in z.files and z["i/bf::bf16"].dtype == np.uint16
    back, st2 = jckpt.load(str(tmp_path / "port"))
    assert st2 == jst
    for k in arr:
        assert back[k].dtype == arr[k].dtype
        assert back[k].tobytes() == arr[k].tobytes()
    # a raw 2-byte void array (older checkpoints) reads back as bf16
    raw = checkpoint.decode_arrays({"v": arr["i/bf"].view("V2")})["v"]
    _same(raw, arr["i/bf"])


def test_checkpoint_falls_back_to_older_generation(tmp_path, caplog):
    """Generations are named by the millisecond: the saves sleep between."""
    root = str(tmp_path)
    t = {"a": torch.arange(4, dtype=torch.int32)}
    checkpoint.save(root, t, {"gen": 1})
    time.sleep(0.002)
    newest = checkpoint.save(root, {"a": t["a"] + 1}, {"gen": 2})
    arrays, st = checkpoint.load(root)
    assert st == {"gen": 2} and arrays["a"].tolist() == [1, 2, 3, 4]
    os.truncate(os.path.join(newest, "arrays.npz"), 10)    # torn
    arrays, st = checkpoint.load(root)
    assert st == {"gen": 1} and arrays["a"].tolist() == [0, 1, 2, 3]
    assert "falling back" in caplog.text
    assert jckpt.load(root)[1] == {"gen": 1}
    # _gc keeps the newest two generations
    for g in range(3, 6):
        time.sleep(0.002)
        checkpoint.save(root, t, {"gen": g})
    assert len([d for d in os.listdir(root) if d.startswith("ckpt-")]) == 2
    assert checkpoint.load(root)[1] == {"gen": 5}
