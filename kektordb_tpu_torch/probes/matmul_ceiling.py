"""Matrix-product ceilings of the card, and the transposed-arena scan: the
port of scripts/matmul_ceiling.py.

    python -m kektordb_tpu_torch.probes.matmul_ceiling      # on the card

1. the square 8192^2 bf16 product (the card's dense bf16 rate);
2. the skinny K=128 product [4096, 128] @ [128, 131072], the scan's
   product shape, and the fat K=4096 product [4096, 4096] @ [4096, 4096];
   these three are plain `torch.matmul` calls, as the script left them to
   XLA;
3. `scan_vT` (ops/scan_probe.py, the CUDA kernel replacing the script's
   Pallas kernel) over a transposed bf16 arena vT [D, N] at B=4096,
   N=2^20, D=128, ST=4096, G=8.
Each is timed on the card alone (`probes.timed`: CUDA events around
calls queued behind a sleep) after two warm calls; off the card nothing
is timed. Data is drawn on the device from `seed`.
"""

from __future__ import annotations

import torch

from .. import device as devlib
from ..ops import scan_probe
from . import device_ms, rate


def run(device="cuda", *, M: int = 8192, B: int = 4096, D: int = 128,
        Nc: int = 131072, K2: int = 4096, N2: int = 4096, N: int = 1 << 20,
        ST: int = 4096, G: int = 8, reps: int = 10, seed: int = 0) -> dict:
    """Print and return {"square", "skinny", "fat", "scan_vT"}: each
    {"ms", "flop"} (ms None off the card), plus "device"."""
    dev = devlib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"device": name}

    def report(key, label, fn, flop):
        ms = device_ms(dev, fn, reps)
        out[key] = {"ms": ms, "flop": flop}
        print(f"{label}: {rate(ms, flop)} [{name}]", flush=True)

    a, b = bf16(M, M), bf16(M, M)
    report("square", f"square {M}", lambda: torch.matmul(a, b),
           2.0 * M ** 3)
    del a, b
    q, w = bf16(B, D), bf16(D, Nc)
    report("skinny", f"skinny K={D} out[{B},{Nc}]",
           lambda: torch.matmul(q, w), 2.0 * B * Nc * D)
    del w
    qa, wa = bf16(B, K2), bf16(K2, N2)
    report("fat", f"fat K={K2} out[{B},{N2}]", lambda: torch.matmul(qa, wa),
           2.0 * B * N2 * K2)
    del qa, wa
    v32 = torch.randn((N, D), generator=gen, device=dev)
    vT = v32.T.contiguous().to(torch.bfloat16)
    bias = (v32 ** 2).sum(1)[None, :]
    del v32
    report("scan_vT", f"scan_vT B={B} N={N} D={D} ST={ST} G={G}",
           lambda: scan_probe.scan_vT(q, vT, bias, st=ST, g=G),
           2.0 * B * N * D)
    return out


if __name__ == "__main__":
    run()
