"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the metrics of the run's result line.

Set-up: the client processes start; the cell's data is made from the
seed on the run's device; the Engine is built and loaded and the app
served (`server.Served`); the mix's request kind is sent `warmup_requests`
times, which builds the kernel library where the checkout has none yet
and runs every shape the window sends; a full collection then sweeps
what the set-up left (the window's own objects may still bring one on).
The window opens when the clients are ready: the set-up time is the
time from the start of the process to then.
After the window: the card's memory peak is read, the server stopped and
the Engine freed, and only then does the reference run.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import statistics
import time

import numpy as np

from . import loadgen, spec as speclib
from .server import INDEX, Served

PROFILE_AT = 0.4          # the traced slice starts this far into the window
PROFILE_SECONDS = 5.0     # and lasts this long, or 30% of the window
DRAIN_S = 60.0            # an answer may arrive this long after the window


def _merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _counters() -> dict:
    from kektordb_tpu_torch.ops import distance, fuse, scan
    return {"pass_a launches": scan.pass_a.launches,
            "gather_dist launches": distance.gathered.launches,
            "fused_topk calls": fuse.fused_topk.calls}


class Context:
    """What a metric's reader reads: the cell, the clients' records, the
    judged answers and, in a traced run, the spans and the device trace.
    Times are on the host's monotonic clock, in seconds."""

    def __init__(self, cell, seconds, setup_seconds, records, window, judged,
                 spans, profile, peaks):
        self.cell, self.config, self.mix = cell, cell["config"], cell["mix"]
        self.seconds, self.setup_seconds = seconds, setup_seconds
        self.records, self.window, self.judged = records, window, judged
        self.spans, self.profile, self.peaks = spans, profile, peaks
        self.notes: list[str] = []

    def note(self, line: str) -> None:
        """A line for standard error beside the metrics."""
        self.notes.append(line)

    def latency_s(self) -> np.ndarray:
        """Every request of the window, from when it was due to its
        answer; a request that failed or never came counts as infinite."""
        r = self.records
        return np.where(r["ok"], r["t_done"] - r["t_due"], np.inf)

    def _outside(self, spans):
        """Spans that do not overlap the traced slice or the reading of
        its trace (the profiler's own work slows the host meanwhile)."""
        if self.profile is None or self.profile.window is None:
            return list(spans)
        lo, hi = self.profile.window[0], self.profile.done
        return [s for s in spans if s[1] < lo or s[0] > hi]

    def client_spans(self) -> list[tuple[float, float]]:
        """(sent, answered) of each answered request outside the slice."""
        r = self.records
        return self._outside(list(zip(r["t_send"][r["ok"]].tolist(),
                                      r["t_done"][r["ok"]].tolist())))

    def search_spans(self, outside_slice: bool = True):
        if self.spans is None:
            return []
        return self._outside(self.spans.search) if outside_slice \
            else list(self.spans.search)

    def text_spans(self):
        return [] if self.spans is None else self._outside(self.spans.text)

    def device_events(self):
        """Device operations of the traced slice, and the slice."""
        p = self.profile
        if p is None or not p.events:
            return None, None
        return p.events, p.window


def _device_block(cell, trace_ctx, peak: int, device: str) -> dict:
    import torch
    if device.startswith("cuda"):
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell["workload"]["chips"]),
               "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": int(peak)}
    if trace_ctx is not None:
        from .tracing import union_seconds
        events, window = trace_ctx.device_events()
        if events is not None:
            busy = union_seconds([(s, e) for _, s, e in events], *window)
            out["busy_s"] = busy
            out["window_s"] = window[1] - window[0]
    return out


def _breakdown(ctx: Context) -> dict | None:
    from .tracing import idle_gaps
    events, window = ctx.device_events()
    if events is None:
        return None
    lo, hi = window
    by_op: dict[str, float] = {}
    for name, s, e in events:
        if e > lo and s < hi:
            by_op[name[:160]] = by_op.get(name[:160], 0.0) \
                + min(e, hi) - max(s, lo)
    ranges = {"text": list(ctx.spans.text) if ctx.spans else [],
              "engine": [s[:2] for s in ctx.search_spans(False)],
              "server": list(zip(ctx.records["t_send"].tolist(),
                                 ctx.records["t_done"].tolist()))}
    total: dict[str, float] = {}
    longest: dict[str, float] = {}
    for name, sec in idle_gaps(events, window, ranges):
        total[name] = total.get(name, 0.0) + sec
        longest[name] = max(longest.get(name, 0.0), sec)
    gaps = []
    for name in sorted(total, key=lambda n: -total[n]):
        gaps.append([name, total[name]])
        gaps.append([name + ".longest", longest[name]])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps[:10]}


class _HostWatch:
    """The serving process's collector pauses and CPU time over a window:
    host-side causes of a spread that the metrics alone do not name."""

    def __init__(self):
        import resource
        self._res = resource
        self.pauses: list[tuple[int, float]] = []
        self._t = None
        self.cpu0 = resource.getrusage(resource.RUSAGE_SELF)
        self.wall0 = time.perf_counter()
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def line(self) -> str:
        gc.callbacks.remove(self._cb)
        r = self._res.getrusage(self._res.RUSAGE_SELF)
        wall = time.perf_counter() - self.wall0
        cpu = (r.ru_utime - self.cpu0.ru_utime
               + r.ru_stime - self.cpu0.ru_stime)
        parts = []
        for g in range(3):
            ps = [d for gen, d in self.pauses if gen == g]
            parts.append(f"gen{g} {len(ps)} ({sum(ps)!r} s, longest "
                         f"{max(ps, default=0.0)!r} s)")
        return (f"host: serving process {cpu / wall!r} cores over "
                f"{wall!r} s; collector " + ", ".join(parts))


class Bench:
    """The cell's program, set up once; `window` drives it for one
    measured window, `close` frees it."""

    def __init__(self, workload: str, seed: int, device: str = "cuda", *,
                 overrides: dict | None = None, spec: dict | None = None):
        spec = spec or speclib.load_spec()
        cell = speclib.cell(spec, workload)
        overrides = overrides or {}
        cell["config"] = _merge(cell["config"], overrides.get("config"))
        cell["mix"] = _merge(cell["mix"], overrides.get("mix"))
        self.cell, self.cfg, self.mix = cell, cell["config"], cell["mix"]
        self.seed, self.device = seed, device
        self.served = None

    def setup(self) -> None:
        import torch

        cfg, mix = self.cfg, self.mix
        marks = [("start", time.perf_counter())]
        ds = speclib.plugin("data", cfg["generator"]).make(
            cfg, self.seed, torch.device(self.device))
        self.ds = ds
        rows = ds["rows"].cpu().numpy()
        marks.append(("data", time.perf_counter()))
        self.served = Served(cfg, self.device)
        self.served.load(rows, ds.get("texts"),
                         cfg.get("text", {}).get("field", "text"))
        marks.append(("load", time.perf_counter()))
        self.served.start()
        marks.append(("services and server", time.perf_counter()))
        self.builder_path = speclib.BENCH / "requests" \
            / f"{mix['request']}.py"
        builder = speclib.plugin("requests", mix["request"])
        self.queries = ds["queries"].cpu().numpy()
        self.texts = ds.get("query_texts")
        rng = np.random.default_rng([self.seed, 2])
        for _ in range(int(mix.get("warmup_requests", 1))):
            idx = rng.integers(0, self.queries.shape[0],
                               size=int(mix.get("batch", 1)))
            status, raw = self.served.request(
                builder.ROUTE,
                builder.body(INDEX, self.queries, self.texts, idx, mix))
            if status != 200:
                raise RuntimeError(f"warm-up request failed: {status} "
                                   f"{raw[:500]!r}")
        gc.collect()
        marks.append(("warm-up", time.perf_counter()))
        self.setup_line = "set-up: " + ", ".join(
            f"{name} {t - marks[i][1]!r} s"
            for i, (name, t) in enumerate(marks[1:]))

    def window(self, clients: loadgen.Clients, seconds: float,
               rate: float | None, trace: bool) -> dict:
        """Drive one window; what `run_cell` reads from it."""
        import torch

        spans = None
        if trace:
            from .tracing import Spans
            spans = Spans(self.served.engine, INDEX)
        clients.send_job(self.served.port, INDEX, self.builder_path,
                         self.queries, self.texts, self.seed, seconds,
                         rate=rate, drain_s=DRAIN_S)
        clients.ready()
        before = _counters()
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter() + 0.2
        clients.go(t0)
        host = _HostWatch()
        profile = None
        if trace:
            from .tracing import Profile
            length = min(PROFILE_SECONDS, 0.3 * seconds)
            profile = Profile(t0 + PROFILE_AT * seconds,
                              t0 + PROFILE_AT * seconds + length)
            profile.run()
        records = clients.collect(timeout=seconds + DRAIN_S + 600)
        after = _counters()
        self.collected = time.perf_counter()
        return {"t0": t0, "records": records, "spans": spans,
                "profile": profile, "host": host.line(),
                "path": {k: after[k] - before[k] for k in after}}

    def close(self) -> None:
        """Stop the server and free the Engine's state."""
        import torch
        if self.served is not None:
            self.served.stop()
        self.served = None
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", *, t_start: float | None = None,
             overrides: dict | None = None, spec: dict | None = None,
             client_cpus: list[int] | None = None
             ) -> tuple[dict, list[str]]:
    """(the result line's object, the lines for standard error, the
    compared numbers last). `overrides` merges into the configuration
    (`"config"`) and the mix (`"mix"`): the tests' small sizes. The
    client processes keep to `client_cpus` where given."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(workload, seed, device, overrides=overrides, spec=spec)
    cell, cfg, mix = bench.cell, bench.cfg, bench.mix
    rate = float(mix["rate"]) if mix["loop"] == "open" else None
    clients = loadgen.Clients(mix, client_cpus)
    try:
        bench.setup()
        w = bench.window(clients, seconds, rate, trace)
        peak = torch.cuda.max_memory_allocated() \
            if device.startswith("cuda") else 0
    finally:
        clients.close()
        bench.close()
    stopped = time.perf_counter()
    t0, records, spans, profile = w["t0"], w["records"], w["spans"], \
        w["profile"]
    setup_seconds = t0 - t_start
    ds = bench.ds

    from reference import compare
    answers = {"pool": records["pool"], "rows": records["rows"],
               "dist": records["dist"], "score": records["score"],
               "unanswered": int((~records["ok"]).sum())}
    judged = compare.judge(ds, answers, mix)
    after = (f"after the window: answers in "
             f"{bench.collected - t0 - seconds!r} s (the slowest client "
             f"decoding {float(records['decode_s'].max())!r} s, receiving "
             f"{clients.recv_s!r} s), program "
             f"stopped {stopped - bench.collected!r} s, "
             f"reference {time.perf_counter() - stopped!r} s")
    ctx = Context(cell, seconds, setup_seconds, records, (t0, t0 + seconds),
                  judged, spans, profile,
                  json.loads((speclib.BENCH / "peaks.json").read_text()))
    lines = [bench.setup_line] + _loop_lines(ctx, rate)
    lines += [w["host"] + f"; CPUs: serving process "
              f"{sorted(os.sched_getaffinity(0))}, clients {client_cpus}",
              after]
    lines.append("path: " + ", ".join(f"{k} {v}"
                                      for k, v in w["path"].items()))
    lines.append(f"recall {judged['recall']!r} over "
                 f"{int(records['rows'].shape[0])} answered queries")
    if profile is not None and profile.error:
        lines.append(f"profiler failed: {profile.error}")
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = speclib.plugin("layer_metrics" if trace else "end_to_end",
                           m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    lines += ctx.notes
    checks = {}
    for name, limit in cfg["correct"].items():
        if limit is not None:
            checks[name] = {"value": judged[name], "limit": limit}
    for name, v in judged.items():
        lim = cfg["correct"].get(name)
        lines.append(f"check {name} {v!r} limit "
                     + ("(not compared)" if lim is None else repr(lim)))
    lines.sort(key=lambda s: s.startswith("check "))
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": int(records["ok"].size),
              "failed": int((~records["ok"]).sum()),
              "metrics": metrics,
              "device": _device_block(cell, ctx if trace else None, peak,
                                      device)}
    if trace:
        bd = _breakdown(ctx)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = checks
    return result, lines


def loop_stats(records: dict, t0: float, seconds: float) -> dict:
    """What the load generator saw in one window: requests sent and
    failed, the completed rate (answers within the window over its
    seconds, in requests and in queries), latency from the due time at
    the 50th and 95th percentile, and how late the sends were."""
    r = records
    done = r["ok"] & (r["t_done"] <= t0 + seconds)
    lat = np.where(r["ok"], r["t_done"] - r["t_due"], np.inf)
    fin = lat[np.isfinite(lat)]
    q = statistics.quantiles(fin.tolist(), n=20) if fin.size > 1 \
        else [float("nan")] * 19
    late = (r["t_send"] - r["t_due"])[np.isfinite(r["t_send"])]
    return {"sent": int(r["ok"].size), "failed": int((~r["ok"]).sum()),
            "completed": int(done.sum()) / seconds,
            "completed_queries": int(r["n_queries"][done].sum()) / seconds,
            "p50": q[9] * 1e3, "p95": q[18] * 1e3,
            "late_mean_ms": float(np.mean(late)) * 1e3 if late.size else 0.0,
            "late_max_ms": float(np.max(late)) * 1e3 if late.size else 0.0}


def _loop_lines(ctx: Context, rate) -> list[str]:
    st = loop_stats(ctx.records, ctx.window[0], ctx.seconds)
    offered = f"offered {rate!r}/s, " if rate is not None else ""
    return [f"loop {ctx.mix['loop']}: {offered}sent {st['sent']} requests "
            f"in {ctx.seconds} s, completed in the window "
            f"{st['completed']!r}/s ({st['completed_queries']!r} queries/s)"
            f", failed {st['failed']}; latency p50 {st['p50']!r} ms p95 "
            f"{st['p95']!r} ms; generator late mean "
            f"{st['late_mean_ms']!r} ms max {st['late_max_ms']!r} ms"]
