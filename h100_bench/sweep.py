"""Offer an open-loop cell's traffic at a rising series of rates, after one
set-up, to find the highest rate the program sustains (the knee).

    python3 h100_bench/sweep.py --workload <name> --seed <n> \
        --seconds <s> --rates 50,100,200

For each rate, one window: the offered and the completed rate (answers
within the window over its seconds), the 50th and 95th percentile
latency from the due time, how late the generator sent, and the mean
latency of the window's last quarter over its first (a backlog that grows
through the window reads well above 1). A rate is sustained where the
completed rate is within 2% of the offered one and the backlog does not
grow; the knee is the highest such rate. The cell may be a waiting one
(`waiting/`).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from run import ROOT, _environment, pin


def window_line(rate: float, seconds: float, w: dict) -> dict:
    from harness.cell import loop_stats

    line = {"offered": rate, **loop_stats(w["records"], w["t0"], seconds)}
    r = w["records"]
    lat = np.where(r["ok"], r["t_done"] - r["t_due"], np.inf)
    quarter = max(1, lat.size // 4)
    with np.errstate(invalid="ignore"):
        line["backlog_growth"] = float(np.mean(lat[-quarter:])
                                       / np.mean(lat[:quarter]))
    line["sustained"] = bool(line["completed"] >= 0.98 * rate
                             and line["backlog_growth"] < 1.5)
    line["host"] = w["host"]
    return line


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True,
                   help="comma-separated offered rates, requests/s")
    args = p.parse_args(argv)
    _environment()
    client_cpus = pin()
    import torch

    from harness import loadgen
    from harness.cell import Bench
    from harness.spec import load_spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = Bench(args.workload, args.seed, "cuda",
                  spec=load_spec(ROOT, waiting=True))
    if bench.mix["loop"] != "open":
        print("sweeps an open loop only", file=sys.stderr)
        return 2
    knee = None
    try:
        t = time.perf_counter()
        bench.setup()
        print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
        for rate in [float(x) for x in args.rates.split(",")]:
            clients = loadgen.Clients(bench.mix, client_cpus)
            try:
                w = bench.window(clients, args.seconds, rate, False)
            finally:
                clients.close()
            line = window_line(rate, args.seconds, w)
            print(json.dumps(line), flush=True)
            if line["sustained"]:
                knee = rate
    finally:
        bench.close()
    print(json.dumps({"knee": knee, "card": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
