"""Gather-distance (csrc/gather_dist.cu) timed with cold rows.

    python -m kektordb_tpu_torch.probes.gather_cold        # on the card
    python -m kektordb_tpu_torch.probes.gather_cold --against OLD.cu \\
        --variant mine=build/edited.cu --variant regs=-maxrregcount=96

The graph build reads arena rows scattered over a large arena, mostly from
device memory. Timing one id set over and over would read its rows from
the 50 MB L2 after the first call, and compare an L2 time with an HBM
bound. So the timed calls rotate over enough freshly drawn id sets that
the distinct rows the other sets touch exceed COLD_FACTOR x the L2
(`id_sets`), each set reused only after all the others (`cold_timing`,
on `probes.timed`: the card's own time per call and the host's issue
time).

`--against SRC` builds another gather-distance source, with the C
interface the kernel had before it read ids and queries in place
(int32 ids, f32 queries, converted before the timed calls), and times it
beside the port's kernel at each case in turns (other, port, port,
other). `--variant LABEL=FLAGS` builds csrc/gather_dist.cu again with
extra nvcc flags (a flag ending in .cu names another source with the same
C interface instead) and times it the same way, through the port's
wrapper. The libraries go to
build/probe_libs/. Off the card nothing is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import itertools
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .. import device as devlib
from .. import native
from ..ops import distance as dist
from . import Timing, timed

L2_BYTES = 50e6
COLD_FACTOR = 4
MAX_SETS = 64
MIN_REPS = 20
# the bound: NVIDIA's H100 SXM figures, at the card's power limit
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


class Case(NamedTuple):
    name: str
    B: int
    C: int
    D: int
    N: int
    arena: str         # "f32" or "bf16"
    invalid: float     # share of ids set to -1


GRAPH_SHAPES = ("build beam", "serving beam", "scan re-rank")
# the graph's three gathered() shapes, the TPU scripts' own shape (all ids
# valid: kernel 4; 40% -1: kernel 5), 200-byte rows (4-byte chunks), long
# rows (8 chunks a lane), and the projected read's full-dimension re-rank
# (serve_proj_rerank 128 candidates of a 400k x 384 f32 collection)
CASES = (
    Case("build beam", 512, 256, 128, 1 << 20, "f32", 0.4),
    Case("build beam", 512, 256, 128, 1 << 20, "bf16", 0.4),
    Case("serving beam", 1024, 128, 128, 1 << 20, "f32", 0.4),
    Case("serving beam", 1024, 128, 128, 1 << 20, "bf16", 0.4),
    Case("scan re-rank", 4096, 32, 128, 1 << 20, "f32", 0.4),
    Case("scan re-rank", 4096, 32, 128, 1 << 20, "bf16", 0.4),
    Case("TPU script, kernel 4", 4096, 256, 128, 1 << 20, "bf16", 0.0),
    Case("TPU script, kernel 5", 4096, 256, 128, 1 << 20, "bf16", 0.4),
    Case("D=100 (4-byte chunks)", 512, 256, 100, 1 << 20, "bf16", 0.4),
    Case("D=768 (long rows)", 512, 256, 768, 1 << 18, "f32", 0.4),
    Case("projected re-rank", 1024, 128, 384, 400_000, "f32", 0.0),
)


def row_bytes(D: int, arena: str) -> int:
    return D * (2 if arena == "bf16" else 4)


def touched_bytes(k: int, per_set: float, N: int, rbytes: int) -> float:
    """Expected distinct row bytes that k sets of per_set uniform draws
    over N rows touch."""
    return N * rbytes * (1.0 - math.exp(-k * per_set / N))


def n_sets(B: int, C: int, N: int, invalid: float, rbytes: int) -> int:
    """Sets enough that the other sets touch COLD_FACTOR x L2 of distinct
    rows between two uses of one set (MAX_SETS at most)."""
    per_set = B * C * (1.0 - invalid)
    k = 1
    while k < MAX_SETS - 1 and touched_bytes(
            k, per_set, N, rbytes) < COLD_FACTOR * L2_BYTES:
        k += 1
    return k + 1


def id_sets(B: int, C: int, N: int, invalid: float, rbytes: int, *,
            seed: int, device, dtype=torch.int32) -> list[torch.Tensor]:
    """Freshly drawn [B, C] id sets over N rows, a share `invalid` of each
    set to -1, as many as `n_sets` asks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n_sets(B, C, N, invalid, rbytes)):
        ids = torch.randint(0, N, (B, C), generator=gen, device=device)
        if invalid:
            drop = torch.rand((B, C), generator=gen, device=device) < invalid
            ids = torch.where(drop, -1, ids)
        out.append(ids.to(dtype))
    return out


def cold_timing(dev: torch.device, fn, sets) -> Optional[Timing]:
    """`probes.timed` of fn(ids), the calls rotating over `sets` (a
    multiple of len(sets) timed, MIN_REPS at least)."""
    it = itertools.cycle(sets)
    reps = len(sets) * -(-MIN_REPS // len(sets))
    return timed(dev, lambda: fn(next(it)), reps, warm=1)


def bound_ms(sets, D: int, rbytes: int, q_bytes: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): ids read and outputs written once per
    candidate, queries once, one arena row per valid id (the mean over the
    sets); per valid id a dot and |v|^2 (4 D operations at the f32 rate)."""
    ids = sets[0]
    B, C = ids.shape
    valid = sum(int((s >= 0).sum()) for s in sets) / len(sets)
    nbytes = B * C * (ids.element_size() + 4) + B * D * q_bytes \
        + valid * rbytes
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 4.0 * D * valid / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# other builds, for A/B timing in one call
# ---------------------------------------------------------------------------

def build_source(src: Path, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """nvcc src (with extra flags) alone into build/probe_libs/; ptxas'
    register lines are printed."""
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = native.BUILD_ROOT.parent / "probe_libs" / h.hexdigest()[:16]
    lib = out / "lib.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, *flags,
                              "-shared", "-o", str(lib), str(src)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc {src} {flags}:\n{res.stderr[-4000:]}")
        for ln in (res.stdout + res.stderr).splitlines():
            if "registers" in ln:
                print(f"  {src.name} {' '.join(flags)}: {ln.strip()}")
    return ctypes.CDLL(str(lib))


def earlier_call(src: Path):
    """fn(v, ids, q, metric) -> [B, C] through a source with the earlier C
    interface: kektor_gather_dist(ids int32, q f32, v, out, B, C, D, N,
    vdtype, metric, stream). ids and q must already be int32 and f32."""
    fn = build_source(src).kektor_gather_dist
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_long] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(v, ids, q, metric):
        B, C = ids.shape
        out = torch.empty((B, C), dtype=torch.float32, device=v.device)
        err = fn(ids.data_ptr(), q.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, C, v.shape[1], v.shape[0], dist._DTYPE[v.dtype],
                 dist._METRIC[metric], dist._stream(v.device))
        if err:
            raise RuntimeError(f"{src.name}: CUDA error {err}")
        return out
    return call


def variant_call(flags: tuple[str, ...]):
    """fn(v, ids, q, metric) -> [B, C] through csrc/gather_dist.cu (or the
    source named by a flag ending in .cu, with the same C interface) built
    with the other flags, called through the port's wrapper."""
    src = next((Path(f) for f in flags if f.endswith(".cu")),
               native.CSRC / "gather_dist.cu")
    lib = native.bind(build_source(src, tuple(f for f in flags
                                              if not f.endswith(".cu"))),
                      ("kektor_gather_dist",))

    def call(v, ids, q, metric):
        return dist._gather_dist(v, ids, q, metric, lib=lib)
    return call


def run(device="cuda", *, against: Optional[Path] = None,
        variants: tuple[tuple[str, tuple[str, ...]], ...] = (),
        cases=CASES, seed: int = 0) -> list[dict]:
    """Each case (L2) with cold rows: the port's kernel, and the other
    builds in turns with it, each held to the port's output (max |diff|
    printed). Returns one dict per case: {"case", "ms", "issue_ms",
    "bound_ms", "bound_by", "share", "sets", "others": {label: ms}}."""
    dev = devlib.resolve(device)
    with ThreadPoolExecutor() as pool:          # one nvcc per build at once
        builds = [pool.submit(variant_call, flags) for _, flags in variants]
        others = [("before", earlier_call(Path(against)), True)] \
            if against is not None else []
        others += [(label, b.result(), False)
                   for (label, _), b in zip(variants, builds)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    arenas = {}
    out = []
    for case in cases:
        key = (case.N, case.D, case.arena)
        if key not in arenas:
            arenas.clear()
            v = torch.randn((case.N, case.D), generator=gen, device=dev)
            arenas[key] = v.to(torch.bfloat16) if case.arena == "bf16" else v
        v = arenas[key]
        q = torch.randn((case.B, case.D), generator=gen, device=dev)
        if case.arena == "bf16":
            q = q.to(torch.bfloat16)
        rb = row_bytes(case.D, case.arena)
        sets = id_sets(case.B, case.C, case.N, case.invalid, rb,
                       seed=seed + len(out), device=dev)
        q32 = q.float()
        ref = dist.gathered(v, sets[0], q, dist.L2)

        def port(ids):
            return dist.gathered(v, ids, q, dist.L2)
        calls = {"port": port}
        for label, fn, earlier in others:
            got = fn(v, sets[0], q32 if earlier else q, dist.L2)
            diff = float(torch.nan_to_num(got - ref, posinf=0.0).abs().max())
            print(f"  {case.name} {case.arena}: {label} against the port's "
                  f"kernel, max |diff| {diff:.4g}")
            calls[label] = (lambda f, qq: lambda ids: f(v, ids, qq, dist.L2))(
                fn, q32 if earlier else q)
        times: dict[str, list[float]] = {k: [] for k in calls}
        issue = []
        order = [k for k in calls if k != "port"]
        for turn in (order + ["port"], ["port"] + order[::-1]):
            for label in turn:
                t = cold_timing(dev, calls[label], sets)
                if t is None:
                    continue
                times[label].append(t.ms)
                if label == "port":
                    issue.append(t.issue_ms)
        bms, by = bound_ms(sets, case.D, rb, q.element_size())
        row = {"case": f"{case.name} {case.arena}", "B": case.B, "C": case.C,
               "D": case.D, "sets": len(sets), "bound_ms": bms,
               "bound_by": by,
               "route": dist.gather_route(v) if dev.type == "cuda"
               else None}
        if times["port"]:
            ms = sum(times["port"]) / len(times["port"])
            row.update(ms=ms, issue_ms=sum(issue) / len(issue),
                       share=bms / ms,
                       others={k: sum(t) / len(t) for k, t in times.items()
                               if k != "port"})
            print(f"{row['case']} B={case.B} C={case.C} D={case.D} "
                  f"[{row['route']}], {len(sets)} id sets: port "
                  + ", ".join(f"{t:.4f}" for t in times["port"])
                  + f" ms (host issue {row['issue_ms']:.4f}), bound "
                  f"{bms:.4f} ({by}), share {row['share']:.3f}; "
                  + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in ts)
                              for k, ts in times.items() if k != "port"),
                  flush=True)
        out.append(row)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=FLAGS, nvcc flags separated by spaces")
    args = ap.parse_args()
    variants = tuple((v.split("=", 1)[0], tuple(v.split("=", 1)[1].split()))
                     for v in args.variant)
    run(against=args.against, variants=variants)


if __name__ == "__main__":
    main()
