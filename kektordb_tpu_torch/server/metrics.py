"""Prometheus metrics in text exposition format.

Reference: pkg/metrics/metrics.go:14-44 — kektordb_http_requests_total,
kektordb_http_request_duration_seconds (buckets 5ms-60s),
kektordb_vectors_total gauge; served at /metrics. Beside them the
program's spans (kektordb_tpu_torch/tracing.py): per span name
kektordb_span_seconds_sum, kektordb_span_seconds_count and
kektordb_span_cpu_seconds_sum (the threads' CPU time), the ring's
kektordb_spans_dropped_total, and each counter as kektordb_<name>_total."""

from __future__ import annotations

import threading
from collections import defaultdict

from .. import tracing

BUCKETS = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
           30.0, 60.0]


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests: dict[tuple[str, str, int], int] = defaultdict(int)
        self.dur_buckets: dict[str, list[int]] = defaultdict(
            lambda: [0] * (len(BUCKETS) + 1))
        self.dur_sum: dict[str, float] = defaultdict(float)
        self.dur_count: dict[str, int] = defaultdict(int)
        self.vectors_total = 0

    def observe(self, method: str, path: str, code: int,
                seconds: float) -> None:
        with self._lock:
            self.requests[(method, path, code)] += 1
            b = self.dur_buckets[path]
            for i, edge in enumerate(BUCKETS):
                if seconds <= edge:
                    b[i] += 1
                    break
            else:
                b[-1] += 1
            self.dur_sum[path] += seconds
            self.dur_count[path] += 1

    def render(self) -> str:
        out = [
            "# HELP kektordb_http_requests_total Total HTTP requests",
            "# TYPE kektordb_http_requests_total counter",
        ]
        with self._lock:
            for (m, p, c), n in sorted(self.requests.items()):
                out.append(
                    f'kektordb_http_requests_total{{method="{m}",'
                    f'path="{p}",code="{c}"}} {n}')
            out.append("# HELP kektordb_http_request_duration_seconds "
                       "Request latency")
            out.append("# TYPE kektordb_http_request_duration_seconds "
                       "histogram")
            for p in sorted(self.dur_buckets):
                cum = 0
                for i, edge in enumerate(BUCKETS):
                    cum += self.dur_buckets[p][i]
                    out.append(
                        f'kektordb_http_request_duration_seconds_bucket'
                        f'{{path="{p}",le="{edge}"}} {cum}')
                cum += self.dur_buckets[p][-1]
                out.append(
                    f'kektordb_http_request_duration_seconds_bucket'
                    f'{{path="{p}",le="+Inf"}} {cum}')
                out.append(
                    f'kektordb_http_request_duration_seconds_sum'
                    f'{{path="{p}"}} {self.dur_sum[p]}')
                out.append(
                    f'kektordb_http_request_duration_seconds_count'
                    f'{{path="{p}"}} {self.dur_count[p]}')
            out.append("# HELP kektordb_vectors_total Total stored vectors")
            out.append("# TYPE kektordb_vectors_total gauge")
            out.append(f"kektordb_vectors_total {self.vectors_total}")
        out += span_lines()
        return "\n".join(out) + "\n"


def span_lines() -> list[str]:
    out = []
    totals = sorted(tracing.totals().items())
    for series, kind, help_, pick in (
            ("kektordb_span_seconds_sum", "counter",
             "Wall time in spans, by name", lambda c, w, u: w / 1e9),
            ("kektordb_span_seconds_count", "counter",
             "Spans recorded, by name", lambda c, w, u: c),
            ("kektordb_span_cpu_seconds_sum", "counter",
             "Thread CPU time in spans, by name", lambda c, w, u: u / 1e9)):
        out.append(f"# HELP {series} {help_}")
        out.append(f"# TYPE {series} {kind}")
        for name, (c, w, u) in totals:
            out.append(f'{series}{{name="{name}"}} {pick(c, w, u)}')
    out.append("# HELP kektordb_spans_dropped_total Spans pushed out of "
               "the full ring")
    out.append("# TYPE kektordb_spans_dropped_total counter")
    out.append(f"kektordb_spans_dropped_total {tracing.dropped()}")
    for name, c in sorted(tracing.counters().items()):
        series = "kektordb_" + name.replace(".", "_") + "_total"
        out.append(f"# TYPE {series} counter")
        out.append(f"{series} {c}")
    return out
