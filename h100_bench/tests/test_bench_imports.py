"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the
program."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

PRELUDE = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, "
           f"{str(BENCH)!r}, {str(BENCH / 'tests')!r}]\n")


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _run(
        "if __name__ == '__main__':\n"
        "    from harness.cell import run_cell\n"
        "    from harness.spec import load_spec\n"
        "    from bench_small import SMALL\n"
        "    w = 'fiqa.hybrid-single'\n"
        "    res, _ = run_cell(w, 99, 1.0, True, 'cpu', "
        "overrides=SMALL[w], spec=load_spec(waiting=True))\n"
        "    import run\n"
        "    print(json.dumps({'found': run.forbidden_modules(),\n"
        "        'port': 'kektordb_tpu_torch' in sys.modules,\n"
        "        'correct': res['correct']}))\n")
    assert got == {"found": [], "port": True, "correct": True}


def test_the_check_compares_whole_top_level_names():
    got = _run(
        "import types, run\n"
        "sys.modules['kektordb_tpu_torch_x'] = types.ModuleType('a')\n"
        "sys.modules['jaxtyping'] = types.ModuleType('b')\n"
        "before = run.forbidden_modules()\n"
        "sys.modules['kektordb_tpu.ops'] = types.ModuleType('c')\n"
        "sys.modules['jax'] = types.ModuleType('d')\n"
        "print(json.dumps([before, run.forbidden_modules()]))\n")
    assert got == [[], ["jax", "kektordb_tpu"]]


def test_the_reference_loads_nothing_of_the_program():
    got = _run(
        "import numpy as np, torch\n"
        "from reference import compare, knn, text\n"
        "import control\n"
        "from bench_small import SMALL\n"
        "for w in sorted(SMALL):\n"
        "    control.control_numbers(w, 5, 200, 'cpu', SMALL[w])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
        "    & {'kektordb_tpu_torch', 'kektordb_tpu', 'jax', 'jaxlib',\n"
        "       'flax'})))\n")
    assert got == []
