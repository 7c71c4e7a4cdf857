"""The fused-scan prototype's tile sweep and check: the port of
scripts/scan_pallas_proto.py.

    python -m kektordb_tpu_torch.probes.scan_proto          # on the card

`scan_reduce` (ops/scan_probe.py: bias - 2 * dots with a strided G-group
min / argmin over a row-major bf16 arena, launched as pass A's bf16 form)
at B=4096, N=2^20, D=128 for each (BT, ST, G) of the script's sweep. BT,
the TPU's query tile, has no counterpart on the card (a block covers 128
queries); ST and G set the tile and the groups. Then the script's no-arg
line, and its check: the (512, 2048, 8) result on the first 8 queries and
one tile against a float64 recomputation from the same bf16 inputs, where
the first member wins a tie. Timed on the card alone (`probes.timed`:
CUDA events around calls queued behind a sleep) after two warm calls;
off the card nothing is timed. Data is drawn on the device from
`seed`.
"""

from __future__ import annotations

import torch

from .. import device as devlib
from ..ops import scan_probe
from . import device_ms, rate

# (BT, ST, G) of the script's sweep, in its order
TUPLES = ((512, 2048, 8), (256, 2048, 8), (256, 4096, 8), (512, 4096, 8),
          (256, 4096, 16), (1024, 2048, 8), (512, 2048, 16))
CHECK = (512, 2048, 8)
CHECK_QUERIES = 8


def check_slice(q, v, bias, gmin, garg, *, st: int, g: int) -> dict:
    """The script's check: the first CHECK_QUERIES queries over the first
    tile, recomputed in float64 from the bf16 inputs with a strict `<` fold
    (the first member wins a tie). Returns {"gmin_err", "garg_match"}."""
    W = st // g
    nq = min(CHECK_QUERIES, q.shape[0])
    scores = bias.reshape(-1)[:st].double() - 2.0 * (
        q[:nq].double() @ v[:st].double().T)
    gm = scores[:, :W].clone()
    ga = torch.zeros((nq, W), dtype=torch.int32, device=q.device)
    for m in range(1, g):
        sl = scores[:, m * W:(m + 1) * W]
        ga = torch.where(sl < gm, m, ga)
        gm = torch.minimum(gm, sl)
    return {"gmin_err": float((gmin[:nq, :W].double() - gm).abs().max()),
            "garg_match": float((garg[:nq, :W] == ga).double().mean())}


def run(device="cuda", *, B: int = 4096, N: int = 1 << 20, D: int = 128,
        tuples=TUPLES, check=CHECK, reps: int = 10, seed: int = 0) -> dict:
    """Print and return {"sweep": [{"bt", "st", "g", "ms", "flop"}],
    "check": {"gmin_err", "garg_match"}, "device"}; ms is None off the
    card."""
    dev = devlib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v32 = torch.randn((N, D), generator=gen, device=dev)
    v = v32.to(torch.bfloat16)
    bias = (v32 ** 2).sum(1)[None, :]
    del v32
    q = torch.randn((B, D), generator=gen, device=dev).to(torch.bfloat16)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    flop = 2.0 * B * N * D
    sweep = []
    for bt, st, g in tuples:
        ms = device_ms(dev, lambda: scan_probe.scan_reduce(q, v, bias, st=st,
                                                           g=g), reps)
        sweep.append({"bt": bt, "st": st, "g": g, "ms": ms, "flop": flop})
        print(f"BT={bt:4d} ST={st:5d} G={g:2d}: {rate(ms, flop)} [{name}]",
              flush=True)
    print(f"no-arg BT={check[0]} ST={check[1]}: not built, the with_arg="
          "False variant is not ported (it writes garg = 0 and would time "
          "the same launch)", flush=True)
    bt, st, g = check
    gmin, garg = scan_probe.scan_reduce(q, v, bias, st=st, g=g)
    res = check_slice(q, v, bias, gmin, garg, st=st, g=g)
    print(f"gmin err: {res['gmin_err']} garg match: {res['garg_match']}",
          flush=True)
    return {"device": name, "sweep": sweep, "check": res}


if __name__ == "__main__":
    run()
