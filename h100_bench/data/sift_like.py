"""SIFT-like rows and queries, made on the device from the seed.

A copy of the repository's `make_sift_like` (bench.py), in torch on the
run's device: clustered byte-range vectors approximating SIFT local
descriptors, many anisotropic clusters with gamma(2, 1)-tailed offsets,
clipped to [0, 255], the cluster count growing with the rows
(max(4096, n / 64)) so the top-10 boundary stays crisp. The query pool is
drawn from the same distribution after the rows, as ANN-benchmarks'
query set is drawn from SIFT's own descriptors.
"""

from __future__ import annotations

import torch

BLOCK = 262_144


def make(cfg: dict, seed: int, device: torch.device) -> dict:
    ds = cfg["dataset"]
    n, d, nq = int(ds["rows"]), int(ds["dim"]), int(ds["queries"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_clusters = max(4096, n // 64)
    centers = torch.rand(n_clusters, d, generator=g, device=device) * 160.0
    scales = 8.0 + 6.0 * torch.rand(n_clusters, 1, generator=g,
                                    device=device)
    out = torch.empty(n + nq, d, device=device)
    for i in range(0, n + nq, BLOCK):
        m = min(BLOCK, n + nq - i)
        which = torch.randint(0, n_clusters, (m,), generator=g,
                              device=device)
        u = torch.rand(2, m, d, generator=g, device=device)
        gamma2 = -(torch.log1p(-u[0]) + torch.log1p(-u[1]))
        sign = torch.randint(0, 2, (m, d), generator=g, device=device,
                             dtype=torch.int8).float() * 2.0 - 1.0
        out[i:i + m] = (centers[which] + gamma2 * sign * scales[which]
                        ).clamp_(0.0, 255.0)
    return {"metric": ds["metric"], "rows": out[:n], "queries": out[n:]}
