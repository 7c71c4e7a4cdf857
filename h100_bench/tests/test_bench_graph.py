"""The graph cell, `sift1m-graph.beam1024`, end to end on the CPU at a
small size: the served beam read is `correct` with and without tracing,
its program-side per-layer metrics read numbers, a planted fault fails
the comparison, and the configuration's graph settings are the Engine's
defaults, which the harness relies on (it passes only the index's kind,
metric, precision and serve mode)."""

import inspect
import math

import numpy as np
import pytest

from harness import spec as speclib
from harness.cell import run_cell
from kektordb_tpu_torch.engine.engine import Engine

CELL = "sift1m-graph.beam1024"
ROWS = 4000
# At 4,000 rows the generator draws 4,096 clusters, about one row each,
# so a query's ten nearest are nearly equidistant strangers and the
# graph's recall at ef 100 reads 0.96-0.98 (the textbook search over
# the same graph reads the same, tests/test_torch_graph_reference.py),
# where at 1M rows, 64 to a cluster, it reads above 0.99: `miss` here
# is held to 0.05, every other limit to the cell's own.
SMALL = {"config": {"dataset": {"rows": ROWS, "queries": 300},
                    "correct": {"miss": 0.05}},
         "mix": {"batch": 64, "warmup_requests": 2}}
SPEC = speclib.load_spec()
# read from the program's spans and counters; the other two need a
# device trace, which a CPU run has not
PROGRAM_METRICS = ("index.beam_ms.beam1024", "beam.iterations.beam1024",
                   "graph.link_s.beam1024")
DEVICE_METRICS = ("beam.gather_roofline.beam1024", "device.idle.beam1024")


@pytest.mark.parametrize("trace", [False, True])
def test_the_graph_cell_runs_and_is_correct(trace):
    # a CPU beam request takes about a second: the traced run's window
    # leaves requests before and after the traced slice for the spans
    result, lines = run_cell(CELL, 2**33 + 41, 8.0 if trace else 2.0,
                             trace, "cpu", overrides=SMALL, spec=SPEC)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = speclib.cell(SPEC, CELL)
    want = cell["per_layer" if trace else "end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in want}
        return
    assert {m["name"] for m in want} == set(PROGRAM_METRICS) \
        | set(DEVICE_METRICS)
    for name in PROGRAM_METRICS:
        assert name in result["metrics"], (name, lines)
        assert math.isfinite(result["metrics"][name]["value"]), name
    assert result["metrics"]["beam.iterations.beam1024"]["value"] >= 1
    assert result["metrics"]["graph.link_s.beam1024"]["value"] > 0
    for name in DEVICE_METRICS:
        assert name not in result["metrics"]


_search = Engine.search


def last_hit_swapped(self, index, query, *a, **kw):
    """Each answer's last hit replaced by a random row outside it."""
    out = _search(self, index, query, *a, **kw)
    rng = np.random.default_rng(len(out["ids"]))
    for row in out["ids"]:
        while True:
            other = str(int(rng.integers(0, ROWS)))
            if other not in row:
                break
        row[-1] = other
    return out


def test_a_swapped_last_hit_is_not_correct(monkeypatch):
    monkeypatch.setattr(Engine, "search", last_hit_swapped)
    result, lines = run_cell(CELL, 4243, 2.0, False, "cpu",
                             overrides=SMALL, spec=SPEC)
    assert not result["correct"], lines


def test_the_graph_settings_are_the_engines_defaults():
    cfg = speclib.cell(SPEC, CELL)["config"]["index"]
    defaults = inspect.signature(Engine.create_index).parameters
    for key in ("m", "ef_construction", "ef_search"):
        assert cfg[key] == defaults[key].default, key
    assert cfg["serve_mode"] == "beam"
