"""The two scan-probe kernels of scripts/, ported: the scan's product and
its G-group min / argmin, with score = bias - 2 * dot(q, v) over a bf16
arena (the L2 serving score of ops/scan.py with biasB = 2).

* `scan_vT` replaces `scan_vT` of scripts/matmul_ceiling.py: a
  TRANSPOSED arena vT [D, N], launched through `scan.launch_pass_a` as
  the C entry `kektor_scan_vt`, which runs the tensor-core pass A
  (csrc/scan_pass_a_wgmma.cu); its producer transposes the arena tiles
  on their way to shared memory.
* `scan_reduce` replaces `scan_reduce` of `make_kernel` in
  scripts/scan_pallas_proto.py: a row-major arena v [N, D]. Its function
  is pass A's bf16 form with biasB = 2 (`dots * 2` is exact), so it
  launches pass A itself (`scan.launch_pass_a`).

Both return (gmin [B, ceil(N/st) * st/g] f32, garg [same] int32) with
pass A's group layout: group j of tile t covers rows t*st + j + m*(st/g),
and garg holds the winning member m, the largest on a tie, as the TPU
kernels' `where(scores == gmin, m, garg)` fold gives. A ragged last tile
scores +inf past N. The TPU kernels' query tile BT has no counterpart: the
card's block always covers 128 queries.

The TPU kernel's `with_arg=False` variant (garg written as zeros) is not
ported: the running argmin costs registers and one select per member,
and the store of garg is the same in both, so it would time the same
launch.

Each wrapper takes its plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises, and counts the launch in
`<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from . import scan


def _bias(bias: torch.Tensor, n: int) -> torch.Tensor:
    """The scripts' [1, N] bias (or [N]) as a float32 [N] vector."""
    b = bias.reshape(-1)
    if b.shape != (n,) or b.dtype != torch.float32:
        raise ValueError(f"bias must be float32 [N] or [1, N], N={n}")
    return b


def scan_vT_plain(q, vT, bias, *, st: int, g: int):
    """Plain PyTorch `scan_vT`: pass A's plain version on the view vT.T
    (its chunks are made contiguous one at a time, so the arena is never
    copied whole)."""
    b = _bias(bias, vT.shape[1])
    return scan.pass_a_plain(q, vT.T, b, torch.full_like(b, 2.0), st=st,
                             g=g, form=scan.FORM_BF16)


def scan_vT(q: torch.Tensor, vT: torch.Tensor, bias: torch.Tensor, *,
            st: int, g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """bias - 2 * (q @ vT), G-group min / argmin per tile of st rows:
    q [B, D] bf16, vT [D, N] bf16, bias [N] or [1, N] f32."""
    if not vT.is_cuda:
        return scan_vT_plain(q, vT, bias, st=st, g=g)
    if q.dtype != torch.bfloat16 or vT.dtype != torch.bfloat16:
        raise TypeError("scan_vT takes a bf16 query and arena")
    out = scan.launch_pass_a(q, vT, _bias(bias, vT.shape[-1]), None, st=st,
                             g=g, form=scan.FORM_BF16, transposed=True)
    scan_vT.launches += 1
    return out


scan_vT.launches = 0


def scan_reduce_plain(q, v, bias, *, st: int, g: int):
    """Plain PyTorch `scan_reduce`: pass A's plain version, bf16 form,
    biasB = 2."""
    b = _bias(bias, v.shape[0])
    return scan.pass_a_plain(q, v, b, torch.full_like(b, 2.0), st=st, g=g,
                             form=scan.FORM_BF16)


def scan_reduce(q: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, *,
                st: int, g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """bias - 2 * (q @ v.T), G-group min / argmin per tile of st rows:
    q [B, D] bf16, v [N, D] bf16, bias [N] or [1, N] f32."""
    if not v.is_cuda:
        return scan_reduce_plain(q, v, bias, st=st, g=g)
    if q.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("scan_reduce takes a bf16 query and arena")
    b = _bias(bias, v.shape[0])
    out = scan.launch_pass_a(q, v, b, torch.full_like(b, 2.0), st=st, g=g,
                             form=scan.FORM_BF16)
    scan_reduce.launches += 1
    return out


scan_reduce.launches = 0
