"""The metrics that read the program's spans (harness/program_spans.py),
from a `--trace 1` run of the batch cell on the CPU at a small size:
each reads a finite number, but the one that needs a device trace, and
the request's parts add up to it."""

import math
import time

from bench_small import SMALL

from harness import program_spans
from harness import spec as speclib
from harness.cell import Context, run_cell

CELL = "sift1m.batch4096"
SPAN_METRICS = ["http.parse_ms.batch", "http.encode_ms.batch",
                "http.self_ms.batch", "http.outside_ms.batch",
                "engine.lock_wait_ms.batch", "engine.scan_ms.batch",
                "engine.assemble_ms.batch", "host.offcpu_share.batch"]


def test_span_metrics_read_and_the_parts_add_up():
    spec = speclib.load_spec()
    t_from = time.perf_counter()
    result, lines = run_cell(CELL, 2**33 + 29, 2.0, True, "cpu",
                             overrides=SMALL[CELL], spec=spec)
    t_to = time.perf_counter()
    assert result["correct"], lines
    metrics = result["metrics"]
    for name in SPAN_METRICS:
        assert name in metrics, (name, lines)
        assert math.isfinite(metrics[name]["value"]), name
    # no device trace on the CPU
    assert "device.idle_outside_spans.batch" not in metrics
    share = metrics["host.offcpu_share.batch"]["value"]
    assert 0.0 <= share <= 1.0
    assert any(line.startswith("request: ") for line in lines), lines

    # every request of the run, set-up's included
    cell = speclib.cell(spec, CELL)
    ctx = Context(cell, t_to - t_from, 0.0, None, (t_from, t_to), None,
                  None, None, {})
    d = program_spans.decomposition(ctx)
    assert d["requests"] > 0
    parts = d["parse"] + d["wait"] + d["encode"] + d["self"] + d["search"]
    assert abs(parts - d["request"]) <= 0.1 * d["request"], d
    engine = sum(d[p] for p in program_spans.ENGINE_PARTS)
    assert abs(engine - d["per search"]) <= 0.1 * d["per search"], d
