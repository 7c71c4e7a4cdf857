"""The JAX package's own test cases, run against the port: a reference
test file's source is read, every `kektordb_tpu` module becomes its
`kektordb_tpu_torch` copy, and every index, mesh and Engine the cases make
runs on DEVICE. A port test file execs the result to collect the cases
under their own names; the tests here hold each such source to the port
alone, and every case of every reference file to one account: run against
the port, or listed in NOT_TRANSPOSED with the port test that holds its
promise.

DEVICE is the CPU unless KEKTOR_TORCH_TEST_DEVICE names another torch
device (`KEKTOR_TORCH_TEST_DEVICE=cuda` runs the cases on the card). It is
read here only; the port's own default stays "cuda"."""

import ast
import inspect
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
DEVICE = os.environ.get("KEKTOR_TORCH_TEST_DEVICE", "cpu")

# the port's calls that take `device=` (default "cuda") where the
# reference's ran on JAX's default device
DEVICE_CALLS = ("EngineConfig", "HNSWIndex", "BruteForceIndex",
                "HostArenaIndex", "ShardedHNSW", "make_mesh", "replica_mesh",
                "load_index", "from_reference_state")


def _with_device(src: str) -> str:
    """Each call of a DEVICE_CALLS name that names no device gets
    `device=DEVICE` after its last argument (line numbers kept)."""
    lines = [ln.encode() for ln in src.split("\n")]   # ast counts bytes
    edits = []
    for n in ast.walk(ast.parse(src)):
        if not isinstance(n, ast.Call):
            continue
        name = getattr(n.func, "id", getattr(n.func, "attr", None))
        if name not in DEVICE_CALLS or \
                any(kw.arg == "device" for kw in n.keywords):
            continue
        last = max([(a.end_lineno, a.end_col_offset)
                    for a in n.args + n.keywords], default=None)
        if last is None:     # name(): before the closing parenthesis
            edits.append((n.end_lineno, n.end_col_offset - 1,
                          f'device="{DEVICE}"'))
        else:
            edits.append((*last, f', device="{DEVICE}"'))
    for line, col, text in sorted(edits, reverse=True):
        b = lines[line - 1]
        lines[line - 1] = b[:col] + text.encode() + b[col:]
    return "\n".join(b.decode() for b in lines)


def host_asarray(a, *args, **kwargs) -> np.ndarray:
    """`np.asarray` of the transposed cases: a tensor on any device comes
    to the host first, as `np.asarray` fetches a JAX array from its
    device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, *args, **kwargs)


def port_source(src: str) -> str:
    """A reference test source made the port's: its modules, its devices
    (JAX's device list is the port's visible devices, the counterpart of
    the reference conftest's 8 virtual CPU devices being
    KEKTOR_TORCH_DEVICE_REPEAT), DEVICE in every DEVICE_CALLS call, and
    `np.asarray` taking a tensor from any device."""
    src = re.sub(r"\bkektordb_tpu\b", "kektordb_tpu_torch", src)
    src = re.sub(r"\bnp\.asarray\(", "host_asarray(", src)
    src = re.sub(r"^import numpy as np$", "import numpy as np; from "
                 "test_torch_port_reference import host_asarray", src,
                 flags=re.M)
    src = re.sub(r"^import jax\.numpy as jnp$", "", src, flags=re.M)
    src = re.sub(r"^import jax$",
                 "from kektordb_tpu_torch.device import visible_devices",
                 src, flags=re.M)
    src = re.sub(r"\bjax\.devices\(\)", f'visible_devices("{DEVICE}")', src)
    return _with_device(src)


def _split(names):
    """`names` -> (top-level names, {class: methods kept}) for entries
    written "Class.method"."""
    top, methods = set(), {}
    for n in names or ():
        cls, _, meth = n.partition(".")
        top.add(cls)
        if meth:
            methods.setdefault(cls, set()).add(meth)
    return top, methods


def _first_line(n) -> int:
    # a definition's source starts at its first decorator
    return min([n.lineno] + [d.lineno for d in
                             getattr(n, "decorator_list", ())])


def _kept(node, names, but) -> bool:
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return True
    name = getattr(node, "name", None)
    if names is None:
        return not isinstance(node, ast.Expr) and name not in but
    return name in _split(names)[0]


def reference_cases(filename: str, names=None, but=()) -> str:
    """The reference test file's imports and its top-level definitions
    (all of them but those in `but`, or those in `names`), made the
    port's, each on its own lines of the file (a traceback names the
    reference's line). A name written "Class.method" keeps that class
    with only the methods so named, and the helpers they name."""
    src = (TESTS / filename).read_text()
    lines = src.splitlines()
    out = [""] * len(lines)
    methods = _split(names)[1]

    def keep(n, stop=None):
        first = _first_line(n)
        out[first - 1:stop or n.end_lineno] = \
            lines[first - 1:stop or n.end_lineno]

    for n in ast.parse(src).body:
        if not _kept(n, names, but):
            continue
        if getattr(n, "name", None) not in methods:
            keep(n)
            continue
        tests = [m for m in n.body if getattr(m, "name", "") in
                 methods[n.name]]
        used = {getattr(x, "attr", getattr(x, "id", None))
                for m in tests for x in ast.walk(m)}
        keep(n, stop=_first_line(n.body[0]) - 1)     # decorators, header
        for m in n.body:
            if m in tests or not isinstance(
                    m, (ast.FunctionDef, ast.ClassDef)) or m.name in used:
                keep(m)
    return port_source("\n".join(out) + "\n")


def case_names(filename: str, names=None, but=()) -> list[str]:
    """The cases of `reference_cases(filename, names, but)`: its top-level
    test functions and classes, and "Class.method" for a class it
    splits."""
    tree = ast.parse((TESTS / filename).read_text())
    methods = _split(names)[1]
    out = []
    for n in tree.body:
        if not isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                or not n.name.startswith(("test_", "Test")) \
                or not _kept(n, names, but):
            continue
        out += [f"{n.name}.{m}" for m in sorted(methods[n.name])] \
            if n.name in methods else [n.name]
    return out


def repeat_devices(n: int = 8):
    """A module-scoped autouse fixture that makes n devices visible
    (KEKTOR_TORCH_DEVICE_REPEAT=n) for one test module, the reference's
    module fixtures included (autouse fixtures of a scope run first), and
    restores the variable for the next module on the worker."""
    @pytest.fixture(scope="module", autouse=True)
    def _repeat_devices():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("KEKTOR_TORCH_DEVICE_REPEAT", str(n))
            yield
    return _repeat_devices


def torch_threads(n: int = 1):
    """A module-scoped autouse fixture that runs one test module's torch
    CPU ops on n threads and restores the count after. Under xdist every
    worker's torch would take every core; the JAX package's cases that
    time two reads on the other workers (its decayed searches) then see
    the clock move between them."""
    @pytest.fixture(scope="module", autouse=True)
    def _torch_threads():
        before = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(before)
    return _torch_threads


# Reference cases that no port file execs, by reference file: the reason,
# and the port tests that hold the same promise. A class split by method
# is listed "Class.method". Every case of every reference file is run
# through `reference_cases` or listed here, never both.
_ITEM_14 = "a TPU workaround the port drops (ROADMAP.md section 1, item 14: "
_JNP = "feeds jnp arrays to the op-level functions; its counterpart, " \
    "the same assertions on torch tensors on DEVICE, is "
NOT_TRANSPOSED = {
    "test_hnsw.py": {
        "test_nav_table_beam_serving": (
            _ITEM_14 + "serve_nav_width and the nav table); the port's "
            "beam reads the full neighbour table, whose recall the other "
            "cases of the file hold", ()),
    },
    "test_sharded.py": {
        "test_mesh_residency": (
            _ITEM_14 + "the stacked [S, ...] serving state); it reads a "
            "JAX mesh's devices and the stacked leaves' shards",
            ("tests/test_torch_sharded.py::test_mesh_residency",)),
        "test_capacity_scales_linearly_with_devices": (
            _ITEM_14 + "the stacked serving state, `_get_stacked`)",
            ("tests/test_torch_sharded.py::"
             "test_capacity_scales_linearly_with_devices",)),
    },
    "test_distance.py": {
        name: (_JNP + "in test_torch_ref_distance.py",
               (f"tests/test_torch_ref_distance.py::{name}",))
        for name in ("test_pairwise_l2", "test_pairwise_cosine",
                     "test_pairwise_int8_cosine",
                     "test_gathered_matches_pairwise",
                     "test_brute_force_topk", "test_brute_force_topk_masked",
                     "test_brute_force_topk_blocked",
                     "test_brute_force_k_exceeds_valid",
                     "test_quantize_roundtrip",
                     "test_quantize_outlier_robust")},
    "test_scan.py": {
        "TestScanTopk": (_JNP + "in test_torch_ref_scan.py",
                         ("tests/test_torch_ref_scan.py::TestScanTopk",)),
    },
    "test_int8_asym.py": {
        f"TestAsymmetricScan.{name}": (
            _JNP + "in test_torch_ref_int8_asym.py",
            (f"tests/test_torch_ref_int8_asym.py::TestAsymmetricScan::"
             f"{name}",))
        for name in ("test_asym_beats_symmetric_cosine",
                     "test_asym_l2_distances_real_domain",
                     "test_index_level_int8_compress_asym",
                     "test_int8_symmetric_knob")},
    "test_distributed.py": {
        "test_two_process_cpu_cluster": (
            "marked slow; its workers are a JAX script in a string "
            "(jax.distributed over gloo)",
            ("tests/test_torch_distributed.py::"
             "test_two_process_gloo_cluster",)),
        "test_replica_lifecycle_kill_rejoin": (
            "marked slow; its replicas are a JAX script in a string",
            ("tests/test_torch_distributed.py::"
             "test_replica_lifecycle_kill_rejoin",)),
    },
    "test_concurrency.py": {
        "test_engine_concurrent_mixed_load": (
            "marked slow; a wall-clock storm, whose work follows the "
            "host's speed; the port's runs a fixed count of writes",
            ("tests/test_torch_concurrency.py::"
             "test_engine_concurrent_mixed_load_fixed_count",)),
    },
    "test_crash_stress.py": {
        "test_sigkill_recovery": (
            "its killed writer is a JAX script in a string",
            ("tests/test_torch_crash_stress.py::test_sigkill_recovery",)),
        "test_sigkill_mid_stage_backlog": (
            "its killed writer is a JAX script in a string",
            ("tests/test_torch_crash_stress.py::"
             "test_sigkill_mid_stage_backlog",)),
        "test_concurrency_chaos": (
            "a wall-clock storm, whose backlog follows the host's speed; "
            "the port's runs a fixed count of operations",
            ("tests/test_torch_crash_stress.py::test_storm",)),
        "test_chaos_with_background_maintenance": (
            "a wall-clock storm with the background thread, whose backlog "
            "follows the host's speed; the port's runs a fixed count",
            ("tests/test_torch_crash_stress.py::test_storm",)),
    },
    "test_contracts.py": {
        "test_contract": (
            "its server fixture is test_http's; the port's test replays "
            "the same testdata/contracts.json, step by step",
            ("tests/test_torch_server.py::test_contract",)),
    },
    "test_minilm_real.py": {
        "test_minilm_real_weights_reproduce_golden": (
            "the published all-MiniLM-L6-v2 checkpoint and its golden "
            "fixture are not in the repo, and fetching them needs the "
            "network (the reference skips it too)", ()),
    },
}


def _literal_call(call: ast.Call) -> tuple:
    bound = inspect.signature(reference_cases).bind(
        *map(ast.literal_eval, call.args),
        **{k.arg: ast.literal_eval(k.value) for k in call.keywords})
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def transposed_runs() -> list[tuple]:
    """(port file, reference file, names, but) of every `reference_cases`
    call that a port test file execs when it is imported (a module-level
    `exec(...)`; its arguments must be literals)."""
    runs = []
    for path in sorted(TESTS.glob("test_torch_*.py")):
        for stmt in ast.parse(path.read_text()).body:
            if not (isinstance(stmt, ast.Expr)
                    and getattr(stmt.value, "func", None) is not None
                    and getattr(stmt.value.func, "id", "") == "exec"):
                continue
            runs += [(path.name, *_literal_call(n)) for n in ast.walk(stmt)
                     if isinstance(n, ast.Call)
                     and getattr(n.func, "id", "") == "reference_cases"]
    return runs


def reference_files() -> list[str]:
    return sorted(p.name for p in TESTS.glob("test_*.py")
                  if not p.name.startswith("test_torch_"))


def _all_cases(filename: str, split: set) -> list[str]:
    """The file's top-level test functions and classes; a class in
    `split` counts by its test_* methods."""
    out = []
    for n in ast.parse((TESTS / filename).read_text()).body:
        if not isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                or not n.name.startswith(("test_", "Test")):
            continue
        out += [f"{n.name}.{m.name}" for m in n.body
                if isinstance(m, ast.FunctionDef)
                and m.name.startswith("test_")] if n.name in split \
            else [n.name]
    return out


def _defines(node_id: str) -> bool:
    """Does the port test `tests/<file>::<name>[::<method>]` exist?"""
    path, *names = node_id.split("::")
    body = ast.parse((TESTS.parent / path).read_text()).body
    for name in names:
        hit = [n for n in body if getattr(n, "name", None) == name]
        if not hit:
            return False
        body = hit[-1].body if isinstance(hit[-1], ast.ClassDef) else []
    return True


def test_every_reference_case_is_accounted_for():
    ran = {}
    for port, ref, names, but in transposed_runs():
        for case in case_names(ref, names, but):
            ran.setdefault(ref, []).append(case)
    for ref in reference_files():
        listed = NOT_TRANSPOSED.get(ref, {})
        split = {c.partition(".")[0] for c in [*ran.get(ref, ()), *listed]
                 if "." in c}
        assert sorted([*ran.get(ref, ()), *listed]) == \
            sorted(_all_cases(ref, split)), ref
    assert set(NOT_TRANSPOSED) <= set(reference_files())
    for ref, cases in NOT_TRANSPOSED.items():
        for case, (reason, port_tests) in cases.items():
            assert reason, (ref, case)
            assert all(map(_defines, port_tests)), (ref, case, port_tests)


def _imports_of(src: str) -> set[str]:
    """Root modules imported and JAX names read by a source."""
    out = set()
    for n in ast.walk(ast.parse(src)):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module:
            out.add(n.module.split(".")[0])
        elif isinstance(n, ast.Name) and n.id in ("jax", "jnp"):
            out.add(n.id)
    return out


def test_ported_sources_import_only_the_port():
    runs = transposed_runs()
    assert {ref for _, ref, *_ in runs} >= {
        "test_engine.py", "test_hnsw.py", "test_hostarena.py",
        "test_fuse_device.py", "test_http.py", "test_layout.py",
        "test_scan.py", "test_sharded.py", "test_distance.py",
        "test_int8_asym.py", "test_distributed.py", "test_text_persist.py"}
    for port, ref, names, but in runs:
        src = reference_cases(ref, names, but)
        assert not _imports_of(src) & {"jax", "jnp", "kektordb_tpu"}, ref
        assert not re.search(r"\bkektordb_tpu\.", src), ref
        assert all(re.search(rf"^\s*(def|class) {c.rpartition('.')[2]}\b",
                             src, re.M)
                   for c in case_names(ref, names, but)), (port, ref)
    # the files that run the reference's cases alone import none of JAX,
    # so they run where JAX is not installed
    for path in TESTS.glob("test_torch_ref_*.py"):
        assert not _imports_of(path.read_text()) & {
            "jax", "jnp", "kektordb_tpu"}, path.name


_DEVICE_SNIPPETS = [
    ("HNSWIndex()", 'HNSWIndex(device="{}")'),
    ("HNSWIndex(8, dist.L2, config=cfg)",
     'HNSWIndex(8, dist.L2, config=cfg, device="{}")'),
    ("ShardedHNSW(d, mesh=make_mesh(8))",
     'ShardedHNSW(d, mesh=make_mesh(8, device="{0}"), device="{0}")'),
    ('s = "× —"; idx = HostArenaIndex(8, **kw)',
     's = "× —"; idx = HostArenaIndex(8, **kw, device="{}")'),
    ("BruteForceIndex(\n    24,\n)",
     'BruteForceIndex(\n    24, device="{}",\n)'),
    ('HNSWIndex(8, device="cuda")', 'HNSWIndex(8, device="cuda")'),
    ("e = Engine(EngineConfig(start_background=False)).open()",
     'e = Engine(EngineConfig(start_background=False, device="{}")).open()'),
]


@pytest.mark.parametrize("src,want", _DEVICE_SNIPPETS, ids=[
    "no_argument", "positional", "nested", "non_ascii_and_kwargs",
    "trailing_comma", "device_given", "engine_config"])
def test_device_goes_after_the_last_argument(src, want):
    assert _with_device(src) == want.format(DEVICE)


def test_transposed_objects_live_on_device():
    ns = {}
    exec(port_source(
        "from kektordb_tpu.engine import Engine, EngineConfig\n"
        "from kektordb_tpu.index import HNSWIndex, HostArenaIndex\n"
        "from kektordb_tpu.parallel import make_mesh\n"
        "idx = HNSWIndex(8)\n"
        "host = HostArenaIndex(8, chunk_rows=1024)\n"
        "e = Engine(EngineConfig(start_background=False)).open()\n"
        "e.create_index('t', m=8)\n"
        "e.add('t', 'a', [0.5] * 8)\n"
        "mesh = make_mesh(1)\n"), ns)
    want = torch.device(DEVICE).type
    try:
        assert ns["idx"].device.type == want
        assert ns["host"].device.type == want
        assert ns["e"].device.type == want
        assert ns["e"].indexes["t"].index.device.type == want
        assert [d.type for d in ns["mesh"]] == [want]
    finally:
        ns["e"].close()


def test_transposed_case_reaches_the_kernels():
    """A reference case run as the port files run it: on the card its
    graph build launches gather-distance; on the CPU the wrapper runs its
    plain version and counts nothing."""
    from kektordb_tpu_torch.ops import distance as tdist
    ns = {}
    exec(compile(reference_cases("test_hnsw.py", [
        "make_data", "test_delete_excluded_from_results"]),
        "test_hnsw.py", "exec"), ns)
    before = tdist.gathered.launches
    ns["test_delete_excluded_from_results"]()
    launched = tdist.gathered.launches - before
    assert launched > 0 if torch.device(DEVICE).type == "cuda" \
        else launched == 0


def card_node_ids() -> list[str]:
    """The node ids of every reference case run against the port: each
    test_torch_ref_* file whole, the cases other port files take from the
    reference by name, in the reference's order (its cases may build on
    the ones before them)."""
    ids = []
    for port, ref, names, but in transposed_runs():
        if port.startswith("test_torch_ref_"):
            ids.append(f"tests/{port}")
        else:
            ids += [f"tests/{port}::{c.replace('.', '::')}"
                    for c in case_names(ref, names, but)]
    return list(dict.fromkeys(ids))


if __name__ == "__main__":
    # `python -m pytest $(python tests/test_torch_port_reference.py)`
    print(" ".join(card_node_ids()))
