"""Binary-framed append-only journal with CRC validation and resync
recovery: a copy of kektordb_tpu/persist/aof.py, in the same frame format.

Reference: pkg/persistence/frame.go:12-28, the frame layout
[Magic 0xA5][OpCode u8][PayloadLen u32][CRC32 u32][payload]; ReadFrame
validates magic + CRC with a 1 GB payload cap (frame.go:87-131).
LazyAOFWriter (lazy_aof.go:36-113): a daemon thread drains a buffer;
flush every 100 ms, fsync every 1 s, an inline flush at 1000 entries;
snapshot mode diverts writes to an in-memory shadow buffer
(lazy_aof.go:248-268).

The journal carries the mutations between two checkpoints. Replay finds
its frames with the host runtime's C++ scanner (`host_native.scan_frames`,
every frame however many, each corrupt region's offset); `scan_frames`
here is its plain version in Python, which returns the same frames.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Callable, Iterator, Optional

from .. import host_native

MAGIC = 0xA5
_HEADER = struct.Struct("<BBII")   # magic, opcode, payload_len, crc32
MAX_PAYLOAD = 1 << 30

OP_COMMAND = 1


class FrameError(ValueError):
    pass


def encode_frame(payload: bytes, opcode: int = OP_COMMAND) -> bytes:
    if len(payload) > MAX_PAYLOAD:
        raise FrameError("payload exceeds 1GB cap")
    return _HEADER.pack(MAGIC, opcode, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def decode_frame(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """Returns (opcode, payload, next_pos); raises FrameError on corruption."""
    if pos + _HEADER.size > len(buf):
        raise FrameError("truncated header")
    magic, opcode, ln, crc = _HEADER.unpack_from(buf, pos)
    if magic != MAGIC:
        raise FrameError("bad magic")
    if ln > MAX_PAYLOAD:
        raise FrameError("payload exceeds 1GB cap")
    start = pos + _HEADER.size
    end = start + ln
    if end > len(buf):
        raise FrameError("truncated payload")
    payload = buf[start:end]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError("crc mismatch")
    return opcode, payload, end


def scan_frames(buf: bytes) -> tuple[list[tuple[int, int, int]], list[int]]:
    """Every valid frame of a journal image: ([(payload offset, payload
    length, opcode)], [offset of each corrupt region]). After a corrupt
    frame the scan resumes at the next magic byte that starts a frame
    which decodes cleanly (resyncAOF, recovery.go:32-67); with none left,
    it stops."""
    out = []
    corrupt = []
    pos = 0
    n = len(buf)
    while pos < n:
        try:
            opcode, payload, nxt = decode_frame(buf, pos)
            out.append((nxt - len(payload), len(payload), opcode))
            pos = nxt
        except FrameError:
            corrupt.append(pos)
            nxt_pos = None
            scan = pos + 1
            while scan < n:
                scan = buf.find(b"\xa5", scan)
                if scan < 0:
                    break
                try:
                    decode_frame(buf, scan)
                    nxt_pos = scan
                    break
                except FrameError:
                    scan += 1
            if nxt_pos is None:
                break
            pos = nxt_pos
    return out, corrupt


def read_frames(path: str,
                on_corruption: Optional[Callable[[int], None]] = None
                ) -> Iterator[tuple[int, bytes]]:
    """(opcode, payload) of every valid frame of the journal at `path`
    (none if it does not exist), found by the C++ scanner;
    `on_corruption` gets the offset of each corrupt region skipped."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return
    frames = host_native.scan_frames(buf)
    if on_corruption:
        for pos in frames.corrupt.tolist():
            on_corruption(pos)
    for off, ln, opcode in zip(frames.offsets.tolist(),
                               frames.lengths.tolist(),
                               frames.opcodes.tolist()):
        yield opcode, buf[off:off + ln]


class AOFWriter:
    """The journal file (pkg/persistence/aof.go:34), opened for append;
    LazyAOFWriter writes its frames."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")

    def flush(self, fsync: bool = False) -> None:
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def size(self) -> int:
        self._f.flush()
        return os.path.getsize(self.path)

    def truncate(self) -> None:
        self._f.close()
        self._f = open(self.path, "wb")

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class LazyAOFWriter:
    """Batched writer: one daemon thread drains a bounded buffer.

    Writes enqueue without blocking the write path; the thread flushes
    every FLUSH_INTERVAL and fsyncs every FSYNC_INTERVAL; a buffer of
    BUFFER_CAP frames is flushed inline. In snapshot mode writes divert to
    a shadow buffer that end_snapshot_mode returns (lazy_aof.go:248-268).
    """

    FLUSH_INTERVAL = 0.1
    FSYNC_INTERVAL = 1.0
    BUFFER_CAP = 1000

    def __init__(self, path: str):
        self._inner = AOFWriter(path)
        self._buf: list[bytes] = []
        self._shadow: Optional[list[bytes]] = None
        self._lock = threading.Lock()    # guards _buf and _shadow
        # guards the file: the thread's flush must not meet a truncate
        # between its close and reopen
        self._io = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._last_fsync = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def path(self) -> str:
        return self._inner.path

    def write(self, payload: bytes, opcode: int = OP_COMMAND) -> None:
        frame = encode_frame(payload, opcode)
        with self._lock:
            if self._shadow is not None:
                self._shadow.append(frame)
                return
            self._buf.append(frame)
            full = len(self._buf) >= self.BUFFER_CAP
        if full:
            self.flush()

    def flush(self, fsync: bool = False) -> None:
        with self._io:
            with self._lock:
                buf, self._buf = self._buf, []
            if buf:
                self._inner._f.write(b"".join(buf))
            self._inner.flush(fsync=fsync)

    def _run(self) -> None:
        while not self._stop:
            self._wake.wait(self.FLUSH_INTERVAL)
            self._wake.clear()
            if self._stop:
                break
            now = time.monotonic()
            do_sync = now - self._last_fsync >= self.FSYNC_INTERVAL
            if do_sync:
                self._last_fsync = now
            try:
                self.flush(fsync=do_sync)
            except ValueError:
                return  # closed by close() after its join timed out

    # -- snapshot coordination (shadow buffer) -------------------------------

    def begin_snapshot_mode(self) -> None:
        self.flush(fsync=True)
        with self._lock:
            self._shadow = []

    def end_snapshot_mode(self) -> list[bytes]:
        with self._lock:
            shadow, self._shadow = self._shadow or [], None
        return shadow

    def write_raw_frames(self, frames: list[bytes]) -> None:
        """Append already-encoded frames (the shadow buffer's drain after
        a snapshot, recovery.go:477-557)."""
        with self._io:
            if frames:
                self._inner._f.write(b"".join(frames))
            self._inner.flush(fsync=True)

    def size(self) -> int:
        with self._io:
            return self._inner.size()

    def truncate(self) -> None:
        with self._io:
            with self._lock:
                self._buf.clear()
            self._inner.truncate()

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2.0)
        self.flush(fsync=True)
        with self._io:
            self._inner.close()
