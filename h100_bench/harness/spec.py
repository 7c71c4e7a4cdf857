"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (`configs/<file>` as BENCHMARK.json gives
it) and a traffic mix (`traffic/<traffic>.json`); the configuration names
its data generator (`data/<generator>.py`), the mix its request builder
(`requests/<request>.py`); each metric is read by `end_to_end/<name>.py`
or `layer_metrics/<name>.py`. Nothing here knows a name of its own.

`waiting/<cell>.json` holds the entries of a cell that BENCHMARK.json
does not name yet, in BENCHMARK.json's own lists: a benchmark PR brings
the cell back by moving them there. Only the tests, `control.py` and
`sweep.py` read them; the benchmark's own runs read BENCHMARK.json alone.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_plugins: dict[Path, ModuleType] = {}


def load_spec(root: Path = ROOT, waiting: bool = False) -> dict:
    """BENCHMARK.json, and with `waiting` the entries of the waiting
    cells appended to its lists."""
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    if waiting:
        for path in sorted((BENCH / "waiting").glob("*.json")):
            extra = json.loads(path.read_text())
            for key, entries in extra.items():
                spec[key] = spec[key] + entries
    return spec


def plugin(kind: str, name: str) -> ModuleType:
    """The module `<kind>/<name>.py` under the benchmark's folder."""
    path = BENCH / kind / f"{name}.py"
    mod = _plugins.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"h100_bench_{kind}_{name}".replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _plugins[path] = mod
    return mod


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: its entry, configuration, traffic mix
    and the metrics it reports."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    layers = [m for m in spec["per_layer"] if _applies(m, workload, names)]
    return {"workload": w, "config": config, "mix": mix,
            "end_to_end": e2e, "per_layer": layers}
