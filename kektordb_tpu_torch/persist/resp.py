"""RESP command codec: binary-safe array of bulk strings (a copy of
kektordb_tpu/persist/resp.py, byte for byte the same encoding).

Reference: pkg/persistence/resp.go:28-91 (ParseCommand), :93 (FormatCommand).
AOF payloads are RESP-encoded commands like
  *3\r\n$3\r\nSET\r\n$3\r\nfoo\r\n$3\r\nbar\r\n
Values may be raw binary (vector bytes), so everything is length-prefixed.
"""

from __future__ import annotations


class RESPError(ValueError):
    pass


def format_command(*parts: bytes | str) -> bytes:
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        b = p.encode() if isinstance(p, str) else bytes(p)
        out.append(b"$%d\r\n" % len(b))
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


def parse_command(data: bytes) -> list[bytes]:
    """Parse one RESP array; raises RESPError on malformed input."""
    if not data.startswith(b"*"):
        raise RESPError("expected array header")
    nl = data.find(b"\r\n")
    if nl < 0:
        raise RESPError("truncated header")
    try:
        n = int(data[1:nl])
    except ValueError as e:
        raise RESPError("bad array length") from e
    pos = nl + 2
    parts: list[bytes] = []
    for _ in range(n):
        if pos >= len(data) or data[pos:pos + 1] != b"$":
            raise RESPError("expected bulk string")
        nl = data.find(b"\r\n", pos)
        if nl < 0:
            raise RESPError("truncated bulk header")
        try:
            ln = int(data[pos + 1:nl])
        except ValueError as e:
            raise RESPError("bad bulk length") from e
        start = nl + 2
        end = start + ln
        if end + 2 > len(data):
            raise RESPError("truncated bulk body")
        parts.append(data[start:end])
        if data[end:end + 2] != b"\r\n":
            raise RESPError("missing bulk terminator")
        pos = end + 2
    return parts
