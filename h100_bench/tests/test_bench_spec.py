"""BENCHMARK.json against the benchmark's contract, and the harness
driven by it: every name found as a file, none written into run.py."""

import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import spec as speclib

SPEC = speclib.load_spec()
# BENCHMARK.json alone, and with the waiting cells' entries moved in
SPECS = {"benchmark": SPEC, "with_waiting": speclib.load_spec(waiting=True)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(SPEC) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["command"][:2] == ["python3", "h100_bench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and ".." not in p
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("which", sorted(SPECS))
def test_configs(which):
    spec = SPECS[which]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith("h100_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert (BENCH / "data" / f"{cfg['generator']}.py").is_file()
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


@pytest.mark.parametrize("which", sorted(SPECS))
def test_workloads(which):
    spec = SPECS[which]
    seen = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "requests" / f"{mix['request']}.py").is_file()
        if mix["loop"] == "open":
            assert isinstance(mix["rate"], (int, float)) \
                and mix["rate"] > 0
        cell = speclib.cell(spec, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


@pytest.mark.parametrize("which", sorted(SPECS))
@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(which, group):
    spec = SPECS[which]
    names = set()
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        folder = "end_to_end" if group == "end_to_end" else "layer_metrics"
        assert (BENCH / folder / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
        if group == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "source", "layer", "moves"}
            assert m["moves"] in e2e and _line(m["layer"])
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            if "_roofline" in m["name"]:
                assert m["unit"] == "%"
    if group == "end_to_end":
        assert "setup_s" in names


def test_run_py_holds_no_name():
    spec = SPECS["with_waiting"]
    src = (BENCH / "run.py").read_text() \
        + "".join(p.read_text() for p in (BENCH / "harness").glob("*.py"))
    names = [w["name"] for w in spec["workloads"]] \
        + [w["traffic"] for w in spec["workloads"]] \
        + [c["name"] for c in spec["configs"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for n in names:
        assert not re.search(rf"(?<![\w.-]){re.escape(n)}(?![\w-])",
                             src), n


def test_a_waiting_cell_is_not_in_benchmark_json():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPECS["with_waiting"][key]]
        assert len(names) == len(set(names)), key


def test_an_arrival_process_that_is_not_implemented_is_refused():
    from harness.loadgen import schedule
    mix = {"arrivals": "poisson", "batch": 1}
    due, draws = schedule(mix, 20.0, 2.0, 100, 2**33 + 1)
    assert due.size == 40 and draws.shape == (40, 1)
    assert due[0] == 0.0 and due[-1] < 2.0
    for other in ("uniform", None):
        with pytest.raises(ValueError):
            schedule(dict(mix, arrivals=other), 20.0, 2.0, 100, 1)


def test_the_clients_cpus_are_apart_from_the_servers():
    import os

    from harness.loadgen import split_cpus
    split = split_cpus()
    if split is None:
        assert len(os.sched_getaffinity(0)) < 6
        return
    server, clients = split
    assert clients and len(server) >= 2
    assert not set(server) & set(clients)
    assert set(server) | set(clients) == os.sched_getaffinity(0)
