"""What a span of `tracing.py` costs with no profiler attached, and what
the installed torch offers the tracing; one JSON line.

    python -m kektordb_tpu_torch.probes.span_cost

Per repetition: the thread's CPU time and the wall time of 200,000 empty
spans, and the CPU time of as many kernel ranges (nothing while no
profiler runs). Then, under a profiler started the way `/debug/profile`
starts one, how many ranges another thread's spans left in the trace.
"""

from __future__ import annotations

import json
import sys
import threading
import time

N = 200_000


def run() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import tracing
    from ..server.http import _all_threads

    out = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda}
    for rep in range(3):
        t, c = time.perf_counter_ns(), time.thread_time_ns()
        for _ in range(N):
            with tracing.span("cost.span", n=1):
                pass
        out[f"span_cpu_ns_{rep}"] = (time.thread_time_ns() - c) / N
        out[f"span_wall_ns_{rep}"] = (time.perf_counter_ns() - t) / N
        c = time.thread_time_ns()
        for _ in range(N):
            with tracing.kernel_range("cost.range"):
                pass
        out[f"range_cpu_ns_{rep}"] = (time.thread_time_ns() - c) / N

    go, done = threading.Event(), threading.Event()

    def other():
        go.wait()
        for _ in range(3):
            with tracing.span("other.thread"):
                torch.ones(4).sum()
        done.set()

    th = threading.Thread(target=other)
    th.start()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, **_all_threads()) as prof:
        out["profiling_seen"] = tracing.profiling()
        go.set()
        done.wait(30)
    th.join(30)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    out["all_threads_option"] = bool(_all_threads())
    out["other_thread_ranges"] = names.count("other.thread")
    return out


if __name__ == "__main__":
    print(json.dumps(run()))
