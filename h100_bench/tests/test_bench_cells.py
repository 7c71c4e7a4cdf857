"""Each cell end to end on the CPU at a small size: the server, the
client processes and the reference, the result line checked against
BENCHMARK.json's names and units."""

import json

import pytest
from bench_small import SMALL

from harness import spec as speclib
from harness.cell import run_cell

SPEC = speclib.load_spec(waiting=True)


def _check_line(result: dict, workload: str, trace: bool) -> None:
    cell = speclib.cell(SPEC, workload)
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    json.dumps(result)
    want = cell["per_layer" if trace else "end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    assert set(result["metrics"]) <= set(units)
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name]
        assert m["value"] == m["value"]          # not NaN
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(workload, trace):
    result, lines = run_cell(workload, 2**33 + 17, 2.0, trace, "cpu",
                             overrides=SMALL[workload], spec=SPEC)
    _check_line(result, workload, trace)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["attempted"] > 0
    assert lines[-1].startswith("check ")
    if not trace:
        # every end-to-end metric of the cell reads on the CPU too
        names = {m["name"] for m in speclib.cell(SPEC,
                                                 workload)["end_to_end"]}
        assert set(result["metrics"]) == names


@pytest.mark.parametrize(
    "workload", sorted(w["name"] for w in speclib.load_spec()["workloads"]))
def test_a_short_run_on_the_card(card, workload):
    """The command as BENCHMARK.json gives it, for a short window,
    at the cell's own size (skips without a card)."""
    import subprocess
    import sys

    from conftest import ROOT
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", workload,
         "--seed", str(2**31 + 7), "--seconds", "5", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    _check_line(result, workload, False)
    assert result["correct"] and result["device"]["platform"] == "gpu"
