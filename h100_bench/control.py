"""The control of a cell's comparison: the plain reference put in the
program's place, in the precision just below the one the configuration
states (TF32 for float32), judged by the same comparison as a run's
answers. It has to come out as not correct.

    python3 h100_bench/control.py --workload <name> --seeds 1,2,3 \
        --answers <n>

For each seed: the cell's data at its own size, `n` queries drawn from
the pool as the cell's traffic draws them (as many as a run answers), the
control's answers, and the numbers the comparison gives them, each beside
the cell's limit; the cell may be a waiting one (`waiting/`). The
benchmark's own runs do not run it. On the CPU
(`--device cpu`, the tests) TF32 is emulated by rounding the product's
inputs to 10 mantissa bits.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from run import ROOT, _environment


def control_numbers(workload: str, seed: int, answers: int, device: str,
                    overrides: dict | None = None,
                    spec: dict | None = None) -> dict:
    import torch

    from harness import spec as speclib
    from harness.cell import Bench
    from reference import compare

    bench = Bench(workload, seed, device, overrides=overrides,
                  spec=spec or speclib.load_spec(ROOT, waiting=True))
    cfg, mix = bench.cfg, bench.mix
    ds = speclib.plugin("data", cfg["generator"]).make(
        cfg, seed, torch.device(device))
    rng = np.random.default_rng([seed, 3])
    pool = rng.integers(0, ds["queries"].shape[0], size=answers)
    judged = compare.judge(ds, compare.control_answers(ds, pool, mix), mix)
    judged["correct"] = all(judged[n] <= lim
                            for n, lim in cfg["correct"].items()
                            if lim is not None)
    judged["limits"] = cfg["correct"]
    return judged


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--answers", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    _environment()
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = control_numbers(args.workload, seed, args.answers,
                              args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
