"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix and metrics come from
BENCHMARK.json at the root of the checkout and the files it names under
h100_bench/. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device` and, last,
`checks`: each number compared with the plain reference beside its
limit; the same numbers end standard error. Exits non-zero, printing no
result, where CUDA or the cell's cards are missing, where the program
cannot be imported, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kektordb_tpu")
WATCHDOG_S = 1150


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _environment() -> None:
    # the program's caches stay inside the checkout, at fixed paths; no
    # library the program loads may bring JAX in or reach the network
    cache = ROOT / "build" / "h100_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    for k, v in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"),
                 ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[k] = v
    os.environ.pop("KEKTOR_ALLOW_DOWNLOAD", None)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))


def pin() -> list[int] | None:
    """Keep this process, the serving one, off the client processes'
    CPUs, before torch is imported, so that its thread pools size
    themselves to what is left; the clients' CPUs, or None where the
    host has too few cores to split."""
    from harness.loadgen import split_cpus
    split = split_cpus()
    if split is None:
        return None
    os.sched_setaffinity(0, split[0])
    return split[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # a run that hangs prints every thread's stack and exits non-zero
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    _environment()
    from harness import spec as speclib

    spec = speclib.load_spec(ROOT)
    client_cpus = pin()
    import torch

    from harness.cell import run_cell

    chips = {w["name"]: w for w in spec["workloads"]}[args.workload]["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start=T_START,
                             spec=spec, client_cpus=client_cpus)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
