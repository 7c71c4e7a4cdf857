"""Key-value store with prefix scan (reference pkg/core/kv.go:16-98).

Holds auth keys, sessions, and legacy links. Single-writer engine loop makes
the RWMutex unnecessary."""

from __future__ import annotations

from typing import Iterator, Optional


class KVStore:
    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}

    def set(self, key: str, value: bytes | str) -> None:
        self._data[key] = value.encode() if isinstance(value, str) else bytes(value)

    def get(self, key: str) -> Optional[bytes]:
        return self._data.get(key)

    def delete(self, key: str) -> bool:
        return self._data.pop(key, None) is not None

    def scan(self, prefix: str = "") -> Iterator[tuple[str, bytes]]:
        for k in sorted(self._data):
            if k.startswith(prefix):
                yield k, self._data[k]

    def __len__(self) -> int:
        return len(self._data)

    def items(self) -> dict[str, bytes]:
        return dict(self._data)
