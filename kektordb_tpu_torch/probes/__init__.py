"""Probe entry points: the port's counterparts of the TPU probe scripts
under scripts/ (`matmul_ceiling`, `scan_proto`), as functions that tests
and chip_smoke.py call. They run on the card unless asked for the CPU,
and time only on the card."""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

TRIES = 3     # sleeps tried, each 4x the last, until the host is ahead


class Timing(NamedTuple):
    """ms: device milliseconds per call; issue_ms: the host's milliseconds
    per call to issue it; ahead: whether the host had issued every timed
    call before the card reached the first (so ms holds no host gap)."""
    ms: float
    issue_ms: float
    ahead: bool


def _cycles_per_ms(dev: torch.device) -> float:
    """The card's `torch.cuda._sleep` cycles per millisecond, measured
    between CUDA events."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)               # warm
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize(dev)
    return cycles / start.elapsed_time(end)


def timed(dev: torch.device, fn: Callable[[], object], reps: int,
          warm: int = 2) -> Optional[Timing]:
    """The card's own time per call of `fn`, without the host's.

    After `warm` calls, the card is held by a sleep kernel long enough for
    the host to issue all `reps` calls behind it; CUDA events around the
    calls then time them back to back on the card. The host's issue time
    per call is measured beside it, and the sleep is lengthened (TRIES
    sleeps at most) until the host was ahead. None off the card (a CPU
    time is never reported as the card's)."""
    if dev.type != "cuda":
        fn()
        return None
    for _ in range(warm):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    one = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    head = 2.0 * reps * one + 1.0           # ms the card sleeps ahead
    cycles_per_ms = _cycles_per_ms(dev)
    for _ in range(TRIES):
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(int(head * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize(dev)
        ahead = issue < slept.elapsed_time(start)
        out = Timing(start.elapsed_time(end) / reps, issue / reps, ahead)
        if ahead:
            break
        head *= 4
    return out


def device_ms(dev: torch.device, fn: Callable[[], object], reps: int,
              warm: int = 2) -> Optional[float]:
    """Mean device milliseconds per call of `fn` (`timed`); None off the
    card."""
    t = timed(dev, fn, reps, warm)
    return None if t is None else t.ms


def rate(ms: Optional[float], flop: float) -> str:
    """'<ms> ms  <TF/s> TF/s', or a note that nothing was timed."""
    if ms is None:
        return "not timed (cpu: no card time)"
    return f"{ms:8.3f} ms  {flop / ms / 1e9:6.1f} TF/s"
