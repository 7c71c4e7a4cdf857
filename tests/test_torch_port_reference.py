"""The JAX package's own test cases, run against the port: a reference
test file's source is read, every `kektordb_tpu` module becomes its
`kektordb_tpu_torch` copy and every Engine runs on the CPU. A port test
file execs the result to collect the cases under their own names; the
test here holds each such source to the port alone."""

import ast
import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def port_source(src: str) -> str:
    src = re.sub(r"\bkektordb_tpu\b", "kektordb_tpu_torch", src)
    return re.sub(r"\bEngineConfig\(", 'EngineConfig(device="cpu", ', src)


def reference_cases(filename: str, names=None) -> str:
    """The reference test file's imports and its top-level definitions
    (all of them, or those in `names`), made the port's."""
    src = (TESTS / filename).read_text()
    lines = src.splitlines()
    keep = [n for n in ast.parse(src).body
            if isinstance(n, (ast.Import, ast.ImportFrom))
            or (names is None and not isinstance(n, ast.Expr))
            or getattr(n, "name", None) in (names or ())]
    # a definition's source starts at its first decorator
    return port_source("\n\n".join(
        "\n".join(lines[min([n.lineno] + [d.lineno for d in getattr(
            n, "decorator_list", ())]) - 1:n.end_lineno]) for n in keep))


def case_names(filename: str, names=None) -> list[str]:
    """The test functions and classes of `reference_cases`."""
    tree = ast.parse((TESTS / filename).read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name.startswith(("test_", "Test"))
            and (names is None or n.name in names)]


# the reference files whose cases run against the port, and the cases each
# port file takes from it (None: every case)
PORTED = {"test_concurrency.py": ["TestRWLock"],
          "test_idmap.py": None,
          "test_metadata_scale.py": None,
          "test_proxy_streaming.py": None,
          "test_text_persist.py": ["TestBM25"],
          "test_batcher.py": ["test_concurrent_searches_batch_and_agree",
                              "test_filtered_and_text_searches_coalesce"]}


def test_ported_sources_import_only_the_port():
    for name, cases in PORTED.items():
        src = reference_cases(name, cases)
        assert not re.search(r"\bkektordb_tpu\.", src), name
        got = case_names(name, cases)
        assert got and all(f"def {c}" in src or f"class {c}" in src
                           for c in got), name
