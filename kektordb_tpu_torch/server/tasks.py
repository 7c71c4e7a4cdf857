"""Async task manager with TTL cleanup.

Reference: internal/server/task_manager.go:32-137 — tasks carry status
pending/running/completed/failed, results retrievable at
GET /system/tasks/{id}, swept after 24h."""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

TTL = 24 * 3600.0


@dataclass
class Task:
    id: str
    kind: str
    status: str = "pending"           # pending|running|completed|failed
    result: Any = None
    error: Optional[str] = None
    created: float = field(default_factory=time.time)
    finished: Optional[float] = None

    def to_dict(self) -> dict:
        return {"task_id": self.id, "type": self.kind, "status": self.status,
                "result": self.result, "error": self.error,
                "created_at": self.created, "finished_at": self.finished}


class TaskManager:
    def __init__(self) -> None:
        self._tasks: dict[str, Task] = {}
        self._lock = threading.Lock()

    def submit(self, kind: str, fn: Callable[[], Any]) -> Task:
        task = Task(id=uuid.uuid4().hex, kind=kind)
        with self._lock:
            self._sweep()
            self._tasks[task.id] = task

        def run():
            task.status = "running"
            try:
                task.result = fn()
                task.status = "completed"
            except Exception as e:  # noqa: BLE001 - reported to caller
                task.error = str(e)
                task.status = "failed"
            task.finished = time.time()

        threading.Thread(target=run, daemon=True).start()
        return task

    def get(self, task_id: str) -> Optional[Task]:
        with self._lock:
            return self._tasks.get(task_id)

    def _sweep(self) -> None:
        cutoff = time.time() - TTL
        for tid in [t for t, v in self._tasks.items()
                    if v.finished and v.finished < cutoff]:
            del self._tasks[tid]
