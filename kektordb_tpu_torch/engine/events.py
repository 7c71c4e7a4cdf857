"""EventBus — fan-out pub/sub with non-blocking drop-on-full semantics.

Reference: pkg/engine/events.go:5-96. Event types: vector.add / vector.delete /
vector.update / vector.access, edge.create / edge.delete, memory.evolution.
Feeds the SSE endpoint, the Gardener, and the artifact Watcher."""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Event:
    type: str
    index: str = ""
    node_id: str = ""
    payload: dict[str, Any] = field(default_factory=dict)
    ts: float = field(default_factory=time.time)


class EventBus:
    DEFAULT_BUFFER = 256

    def __init__(self) -> None:
        self._subs: dict[int, queue.Queue[Event]] = {}
        self._next = 0
        self._lock = threading.Lock()
        self.dropped = 0

    def subscribe(self, buffer: int = DEFAULT_BUFFER) -> tuple[int, "queue.Queue[Event]"]:
        q: queue.Queue[Event] = queue.Queue(maxsize=buffer)
        with self._lock:
            sid = self._next
            self._next += 1
            self._subs[sid] = q
        return sid, q

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def emit(self, event: Event) -> None:
        """Non-blocking: slow subscribers drop events (events.go:68)."""
        with self._lock:
            subs = list(self._subs.values())
        for q in subs:
            try:
                q.put_nowait(event)
            except queue.Full:
                self.dropped += 1

    def on(self, callback: Callable[[Event], None],
           types: set[str] | None = None) -> threading.Thread:
        """Convenience: spawn a daemon consumer thread."""
        sid, q = self.subscribe()

        def run():
            while True:
                ev = q.get()
                if ev.type == "__close__":
                    self.unsubscribe(sid)
                    return
                if types is None or ev.type in types:
                    callback(ev)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t
