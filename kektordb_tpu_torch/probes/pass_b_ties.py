"""Pass B's two designs, timed on minima with and without ties.

    python -m kektordb_tpu_torch.probes.pass_b_ties        # on the card
    python -m kektordb_tpu_torch.probes.pass_b_ties --device cpu

Pass B (`ops/scan.pass_b`) returns the k smallest of each row of gmin
[B, M] in the order `lax.top_k(-gmin, k)` gives them: ascending, and on
equal values the lower position first. Two designs compute that:

* repair (`scan.pass_b`): `torch.topk` of k + 1; the rows whose run of
  ties crosses the k-th place (their count read by the host) rebuilt from
  gmin; then two sorts of [B, k];
* key (`pass_b_key`): one `torch.topk` over an int64 key, the score's
  order-preserving bits above the position, so no two keys are equal and
  topk's order is the reference's, with no wait for the card.

Both are timed beside the bare `torch.topk` of k (ties undefined) at the
serving read's shape, gmin [4096, 65536], for k = 10 (the exact read) and
32 (the serving read's candidates), on two minima: Gaussian values (no run
of ties across the k-th place) and the same with every value repeated 4
times at neighbouring positions below one lowest value (a run of ties
across the k-th place in nearly every row: the deduplication traffic).
Per design and case: the device time of its kernels under torch.profiler,
the card's time between CUDA events (`probes.timed`, which notes when the
host was not ahead), and the memory it allocates beyond its input. Both
designs are first held equal to a stable sort of the same gmin. Off the
card nothing is timed.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from .. import device as devlib
from ..ops import scan
from . import timed

B, M = 4096, 65536
KS = (10, 32)
REPS = 10
SEED = 5


def pass_b_key(gmin: torch.Tensor, k: int):
    """`scan.pass_b`'s function by one topk of int64 keys: the score's
    float bits mapped to an int32 of the same order (negatives' low 31
    bits flipped; -0 first made +0, so equal scores give equal bits), that
    above the position."""
    k = min(k, gmin.shape[1])
    bits = (gmin + 0.0).view(torch.int32)
    bits ^= (bits >> 31) & 0x7FFFFFFF
    key = bits.to(torch.int64) << 32
    key |= torch.arange(gmin.shape[1], device=gmin.device)
    pos = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    pos &= 0xFFFFFFFF
    return torch.gather(gmin, 1, pos), pos


def designs(k: int) -> dict:
    return {
        "topk alone (ties undefined)":
            lambda g: torch.topk(g, k, dim=1, largest=False, sorted=True),
        "repair (scan.pass_b)": lambda g: scan.pass_b(g, k),
        "key (one int64 topk)": lambda g: pass_b_key(g, k),
    }


def minima(dev: torch.device, b: int, m: int) -> dict:
    """The two gmin of the probe, [b, m] f32 from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    free = torch.randn((b, m), generator=gen, device=dev)
    tied = torch.randn((b, m // 4), generator=gen,
                       device=dev).repeat_interleave(4, dim=1)
    tied[:, 0] = -100.0       # one lowest value shifts the runs off k % 4
    return {"no ties": free, "runs of 4 ties": tied}


def profiled_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: its CUDA kernels' own time under
    torch.profiler over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / 1e3 / reps


def extra_mib(fn, dev) -> float:
    """MiB `fn` allocates at its peak beyond what was allocated before."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20


def run(device="cuda", *, b: int = B, m: int = M) -> list[dict]:
    """Checks both designs against a stable sort, then times every design
    on every gmin [b, m] and k (times None off the card); prints and
    returns one dict per (gmin, k, design)."""
    dev = devlib.resolve(device)
    rows = []
    for case, g in minima(dev, b, m).items():
        ref_d, ref_p = torch.sort(g, dim=1, stable=True)
        for k in KS:
            tied = int((ref_d[:, k] == ref_d[:, k - 1]).sum())
            for name, fn in designs(k).items():
                if not name.startswith("topk"):
                    bd, bp = fn(g)
                    if not (torch.equal(bd, ref_d[:, :k])
                            and torch.equal(bp, ref_p[:, :k])):
                        raise AssertionError(f"{name}, {case}, k={k}: not "
                                             "a stable sort's order")
                t = timed(dev, lambda: fn(g), REPS)
                row = {"shape": [b, m], "gmin": case, "k": k,
                       "tied_rows": tied, "design": name, "ms": None,
                       "issue_ms": None, "ahead": None, "device_ms": None,
                       "extra_mib": None}
                if t is not None:
                    row.update(ms=t.ms, issue_ms=t.issue_ms, ahead=t.ahead,
                               device_ms=profiled_ms(lambda: fn(g), REPS),
                               extra_mib=extra_mib(lambda: fn(g), dev))
                rows.append(row)
                print(line(row), flush=True)
        del ref_d, ref_p
    return rows


def line(r: dict) -> str:
    head = (f"pass B {r['shape']} {r['gmin']} (tied across the k-th "
            f"place in {r['tied_rows']} of {r['shape'][0]} rows), "
            f"k={r['k']}, {r['design']}: ")
    if r["ms"] is None:
        return head + "not timed (no card)"
    return head + (f"device {r['device_ms']:.4f} ms (profiler), events "
                   f"{r['ms']:.4f} ms (host issue {r['issue_ms']:.4f} ms"
                   + ("" if r["ahead"] else ", host NOT ahead")
                   + f"), {r['extra_mib']:.1f} MiB beyond its input")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = devlib.resolve(ap.parse_args().device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    run(dev)


if __name__ == "__main__":
    main()
