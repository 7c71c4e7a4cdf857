"""Probe entry points: the port's counterparts of the TPU probe scripts
under scripts/ (`matmul_ceiling`, `scan_proto`), as functions that tests
and chip_smoke.py call. They run on the card unless asked for the CPU,
and time only on the card."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def device_ms(dev: torch.device, fn: Callable[[], object], reps: int,
              warm: int = 2) -> Optional[float]:
    """Mean milliseconds per call of `fn` on the card, between CUDA events
    after `warm` calls; None off the card (a CPU time is never reported as
    the card's)."""
    if dev.type != "cuda":
        fn()
        return None
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def rate(ms: Optional[float], flop: float) -> str:
    """'<ms> ms  <TF/s> TF/s', or a note that nothing was timed."""
    if ms is None:
        return "not timed (cpu: no card time)"
    return f"{ms:8.3f} ms  {flop / ms / 1e9:6.1f} TF/s"
