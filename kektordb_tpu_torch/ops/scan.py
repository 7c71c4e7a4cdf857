"""Fused scan serving for batched k-NN, the PyTorch port of
kektordb_tpu/ops/scan.py.

The whole arena is scored against a batch of queries in one pass, with the
affine score  biasA[row] - dot(q, x[row]) * biasB[row]  that covers every
metric and precision (see `serving_bias`); masked rows have biasA = +inf.

Two routes, chosen by the reference's own size rule (`_use_kernel`):

* Kernel route, arenas on a CUDA card with >= PALLAS_MIN_ROWS rows.
  Pass A (`pass_a`) reduces each tile of ST rows to G-group minima and
  argmins, so only [B, N/G] reaches device memory. Every form runs on the
  tensor cores (csrc/scan_pass_a_wgmma.cu), each by its own product
  (`FORM_PRODUCTS`); pass B (`pass_b`) is a `torch.topk` over those
  minima with the reference's tie order, then a rebuild of each winner's
  row. The reference's pass B uses the TPU's `approx_min_k` in
  approximate mode; the port's is always exact.
* Exact blocked scan (`_scan_blocked`, the twin of the reference's
  `_scan_xla`) everywhere else: smaller arenas, and every CPU tensor.

`pass_a` takes its plain PyTorch version (`pass_a_plain`) only for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import native, tracing
from . import distance as dist

INF = float("inf")

# Below this row count the G-group argmin's collision loss is measurable
# (two true top-k rows sharing a group keeps only one) and the exact
# blocked scan is cheap anyway: the fused kernel only pays off at scale.
PALLAS_MIN_ROWS = 1 << 17

# pass-A precision forms; the numbers are the `form` argument of the
# kernel's C entry point
FORM_F32, FORM_F32_FAST, FORM_BF16, FORM_INT8, FORM_ASYM, FORM_ASYM_FAST = \
    range(6)

# the tensor-core product each form issues, as (operand type, products
# per output): f32 exact is 3xTF32 (big.big + big.small + small.big),
# asym exact three bf16 pieces of the query times the codes (exact in
# bf16), the fast forms and bf16 one bf16 product, int8 one exact s8 one
FORM_PRODUCTS = {
    FORM_F32: ("tf32", 3),
    FORM_F32_FAST: ("bf16", 1),
    FORM_BF16: ("bf16", 1),
    FORM_INT8: ("int8", 1),
    FORM_ASYM: ("bf16", 3),
    FORM_ASYM_FAST: ("bf16", 1),
}

# (query dtype, arena dtype) of each form, as the kernels read them
FORM_DTYPES = {
    FORM_F32: (torch.float32, torch.float32),
    FORM_F32_FAST: (torch.float32, torch.float32),
    FORM_BF16: (torch.bfloat16, torch.bfloat16),
    FORM_INT8: (torch.int8, torch.int8),
    FORM_ASYM: (torch.float32, torch.int8),
    FORM_ASYM_FAST: (torch.float32, torch.int8),
}

# the kernel's blocks cover 64 groups of one tile, so the GPU's own tile
# is 64 groups wide (see kernel_tiles)
KERNEL_GROUPS = 64

# scores the plain pass A materializes at once (512 MiB of f32)
PLAIN_CHUNK_SCORES = 1 << 27


def g_for(n_rows: int) -> int:
    """Group-min reduction factor: pass-B work scales as N/G, the chance
    that two true top-k rows share a group as G/N, so bigger arenas
    afford bigger G."""
    if n_rows >= (1 << 21):
        return 32
    if n_rows >= (1 << 20):
        return 16
    return 8


def kernel_tiles(n_rows: int) -> tuple[int, int]:
    """(ST, G) for the CUDA pass A. G follows the reference (`g_for`); the
    TPU's ST came from its VMEM budget and lane width, which the card does
    not have, so ST = 64 * G: one tile per block of the kernel, W = 64
    groups, each read as 64 contiguous arena rows per member."""
    g = g_for(n_rows)
    return KERNEL_GROUPS * g, g


def pass_a_form(q_dtype: torch.dtype, v_dtype: torch.dtype, *,
                fast: bool = False, exact: bool = False) -> int:
    """The precision form, by the reference's `_hi_prec_for`: f32 arenas
    take full f32 unless `fast`; asymmetric int8 (float query x codes)
    takes full f32 only in exact mode; bf16 and int8 x int8 have one
    form each."""
    if v_dtype == torch.float32 and q_dtype == torch.float32:
        return FORM_F32_FAST if fast else FORM_F32
    if v_dtype == torch.bfloat16 and q_dtype == torch.bfloat16:
        return FORM_BF16
    if v_dtype == torch.int8 and q_dtype == torch.int8:
        return FORM_INT8
    if v_dtype == torch.int8 and q_dtype == torch.float32:
        return FORM_ASYM if exact and not fast else FORM_ASYM_FAST
    raise TypeError(f"pass A takes no query {q_dtype} x arena {v_dtype}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _form_dots(q: torch.Tensor, v: torch.Tensor, form: int) -> torch.Tensor:
    """[B, D] x [n, D] -> [B, n] f32 dots in the given form."""
    if form == FORM_INT8:
        return dist.int_dots(q, v)
    if form == FORM_F32_FAST:
        return _bf16(q) @ _bf16(v).T
    if form == FORM_ASYM_FAST:
        return _bf16(q) @ v.float().T
    return q.float() @ v.float().T      # f32, bf16 (widened), asym


def pass_a_plain(q, vectors, biasA, biasB, *, st: int, g: int, form: int):
    """Plain PyTorch pass A: the kernel's function, computed a chunk of
    whole tiles at a time (about PLAIN_CHUNK_SCORES scores are held)."""
    B, N = q.shape[0], vectors.shape[0]
    W = st // g
    ntiles = -(-N // st)
    per = max(1, PLAIN_CHUNK_SCORES // max(B * st, 1))
    members = torch.arange(g, dtype=torch.int32, device=q.device)
    gmins, gargs = [], []
    for t0 in range(0, ntiles, per):
        t1 = min(ntiles, t0 + per)
        r0, r1 = t0 * st, min(N, t1 * st)
        s = biasA[r0:r1] - _form_dots(q, vectors[r0:r1], form) \
            * biasB[r0:r1]
        if r1 - r0 < (t1 - t0) * st:          # ragged last tile
            s = torch.nn.functional.pad(s, (0, (t1 - t0) * st - (r1 - r0)),
                                        value=INF)
        s = s.view(B, t1 - t0, g, W)
        mn = torch.amin(s, dim=2)
        # largest member index among those equal to the min (TPU tie rule)
        arg = torch.where(s == mn[:, :, None, :],
                          members.view(1, 1, g, 1), -1).amax(dim=2)
        gmins.append(mn.reshape(B, -1))
        gargs.append(arg.reshape(B, -1))
    return torch.cat(gmins, 1), torch.cat(gargs, 1)


def pass_a(q: torch.Tensor, vectors: torch.Tensor, biasA: torch.Tensor,
           biasB: torch.Tensor, *, st: int, g: int, fast: bool = False,
           exact: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass A: (gmin [B, ceil(N/st) * st/g] f32, garg [same] int32).

    Group j of tile t covers rows t*st + j + m*(st/g), m in [0, g); garg
    holds the winning m (the largest on a tie). On a CUDA tensor this
    launches the kernel in the form's product and counts the launch in
    `pass_a.launches` and in `pass_a.form_launches[form]`; on a CPU tensor
    it runs `pass_a_plain`."""
    form = pass_a_form(q.dtype, vectors.dtype, fast=fast, exact=exact)
    with tracing.kernel_range("scan.pass_a"):
        if not vectors.is_cuda:
            return pass_a_plain(q, vectors, biasA, biasB, st=st, g=g,
                                form=form)
        out = launch_pass_a(q, vectors, biasA, biasB, st=st, g=g, form=form)
    pass_a.launches += 1
    pass_a.form_launches[form] += 1
    return out


def launch_pass_a(q, vectors, biasA, biasB, *, st: int, g: int, form: int,
                  transposed: bool = False):
    """Check the operands and launch pass A in `form` on the current
    stream (the C entry `kektor_scan_pass_a` picks the form's product):
    (gmin, garg) as `pass_a` returns them. `transposed`: `vectors` is a
    bf16 arena vT [D, N], biasB is the constant 2 and is not passed
    (None), and the entry `kektor_scan_vt` runs it.
    Counts nothing: each wrapper that launches it counts its own
    launches. Any B, N and D, and any arena stride, are taken; the
    transposed arena is bf16 only."""
    if form not in FORM_DTYPES or transposed and form != FORM_BF16:
        raise ValueError(f"pass A has no form {form} "
                         f"(transposed={transposed})")
    if (q.dtype, vectors.dtype) != FORM_DTYPES[form]:
        raise TypeError(f"form {form} takes query x arena "
                        f"{FORM_DTYPES[form]}, not {q.dtype} x "
                        f"{vectors.dtype}")
    if q.ndim != 2:
        raise ValueError(f"query must be [B, D], not {tuple(q.shape)}")
    B, D = q.shape
    N = vectors.shape[1 if transposed else 0]
    if vectors.ndim != 2 or vectors.shape[0 if transposed else 1] != D:
        raise ValueError(f"query {tuple(q.shape)} and arena "
                         f"{tuple(vectors.shape)} do not match")
    biases = (biasA,) if transposed else (biasA, biasB)
    if any(b.shape != (N,) or b.dtype != torch.float32 for b in biases):
        raise ValueError("biasA and biasB must be float32 [N]")
    if st <= 0 or g <= 0 or st % g:
        raise ValueError(f"st={st} must be a positive multiple of g={g}")
    for t in (q, vectors, *biases):
        if t.device != vectors.device:
            raise ValueError("pass A operands must lie on one device")
        if not t.is_contiguous():
            raise ValueError("pass A operands must be contiguous")
    if max(B, N) >= 1 << 31:
        raise ValueError("pass A takes fewer than 2^31 queries and rows")
    lib = native.load()
    width = -(-N // st) * (st // g)
    gmin = torch.empty((B, width), dtype=torch.float32, device=q.device)
    garg = torch.empty((B, width), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), vectors.data_ptr(),
            *(b.data_ptr() for b in biases), gmin.data_ptr(),
            garg.data_ptr(), B, N, D, st, g)
    if transposed:
        err = lib.kektor_scan_vt(*args, stream)
    else:
        err = lib.kektor_scan_pass_a(*args, form, stream)
    if err:
        raise RuntimeError(f"scan_pass_a launch failed: CUDA error {err}")
    return gmin, garg


pass_a.launches = 0
pass_a.form_launches = [0] * len(FORM_DTYPES)


def pass_b(gmin: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of gmin [B, M], as `lax.top_k(-gmin, k)`
    gives them: (values ascending [B, k], positions [B, k] int64), and on
    equal values the lower position first, both in which positions win
    and in their order.

    `torch.topk` leaves ties undefined, so it is asked for k + 1: where
    the (k+1)-th value equals the k-th (a finite run of ties across the
    last place), the row's winners are rebuilt from gmin (every value
    below the k-th, then the lowest positions equal to it). Rows tied
    only at +inf keep topk's choice: their rows are -1 either way. Then
    the k winners are ordered by (value, position), two sorts of [B, k].
    No sort of the whole [B, M]; finding the tied rows waits for the card
    once (their count decides the repair's shape)."""
    with tracing.kernel_range("scan.pass_b"):
        return _pass_b(gmin, k)


def _pass_b(gmin: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    kk = min(k + 1, gmin.shape[1])
    vals, pos = torch.topk(gmin, kk, dim=1, largest=False, sorted=True)
    bd, bp = vals[:, :k], pos[:, :k]
    if kk > k:
        tied = (vals[:, k] == vals[:, k - 1]) & torch.isfinite(vals[:, k])
        bad = tied.nonzero().squeeze(1)
        if bad.numel():
            g = gmin[bad]
            t = bd[bad, k - 1:k]
            below = g < t
            eq = g == t
            need = k - below.sum(1, keepdim=True)
            take = below | (eq & (torch.cumsum(eq, 1, dtype=torch.int32)
                                   <= need))
            p = take.nonzero()[:, 1].view(-1, k)    # ascending per row
            bp = bp.index_put((bad,), p)
            bd = bd.index_put((bad,), torch.gather(g, 1, p))
    bp, order = torch.sort(bp, dim=1)
    bd = torch.gather(bd, 1, order)
    bd, order = torch.sort(bd, dim=1, stable=True)
    return bd, torch.gather(bp, 1, order)


def _scan_kernel(q, vectors, biasA, biasB, k: int, *, exact: bool = False,
                 fast: bool = False, st: Optional[int] = None,
                 g: Optional[int] = None):
    """Pass A + pass B (the reference's `_scan_pallas`): ascending scores
    [B, k] and rows [B, k] int32, -1 where the score is inf. `st`/`g`
    default to the GPU's `kernel_tiles`; tests pass the TPU's."""
    if st is None:
        st, g = kernel_tiles(vectors.shape[0])
    W = st // g
    gmin, garg = pass_a(q, vectors, biasA, biasB, st=st, g=g, fast=fast,
                        exact=exact)
    bd, bp = pass_b(gmin, k)
    m = torch.gather(garg, 1, bp).long()
    rows = (bp // W) * st + bp % W + m * W
    rows = torch.where(torch.isinf(bd), -1, rows).int()
    return bd, rows


def _block_dots(q, blk):
    """Exact-scan dots: int8 x int8 in the integer domain, everything else
    in full f32 of the values as given (a bf16 arena's rows are exact in
    f32; an f32 query against them stays f32, as the reference's
    `dot_general` promotes it)."""
    if blk.dtype == torch.int8 and q.dtype == torch.int8:
        return dist.int_dots(q, blk)
    return q.float() @ blk.float().T


def _scan_blocked(q, vectors, biasA, biasB, k: int, block: int = 16384):
    """Exact blocked scan with a running top-k merge (the reference's
    `_scan_xla`): the same scores, every row."""
    B, N = q.shape[0], vectors.shape[0]
    dev = vectors.device
    cd = torch.full((B, k), INF, device=dev)
    ci = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, N, block):
        stop = min(start + block, N)
        scores = biasA[start:stop] - _block_dots(q, vectors[start:stop]) \
            * biasB[start:stop]
        idx = torch.arange(start, stop, dtype=torch.int32, device=dev)
        cd, ci = dist.merge_topk(
            torch.cat([cd, scores], 1),
            torch.cat([ci, idx[None, :].expand(B, -1)], 1), k)
    return cd, torch.where(torch.isinf(cd), -1, ci)


def _use_kernel(vectors: torch.Tensor) -> bool:
    return vectors.is_cuda and vectors.shape[0] >= PALLAS_MIN_ROWS


def scan_topk(q, vectors, biasA, biasB, k: int, *, mode: str = "auto"):
    """Fused scan top-k: (scores [B, k] ascending, rows [B, k])."""
    if _use_kernel(vectors):
        return _scan_kernel(q, vectors, biasA, biasB, k,
                            exact=mode == "exact")
    return _scan_blocked(q, vectors, biasA, biasB, k)


def serving_bias(vectors, norms, live, metric: str,
                 quantum: Optional[torch.Tensor] = None):
    """(biasA, biasB) for the score form, +inf in biasA for dead rows.
      L2 f32/bf16 : biasA = |x|^2 (norms hold it), biasB = 2
      cosine      : biasA = 0,                       biasB = 2
      int8 L2     : biasA = |x_int|^2,               biasB = 2
      int8 asym L2: biasA = |quantum x_int|^2,       biasB = 2 quantum
      int8 cosine : biasA = 0,                       biasB = 2 / |x_int|"""
    mask = torch.where(live, 0.0, INF)
    if vectors.dtype == torch.int8:
        if metric == dist.COSINE:
            return mask, 2.0 / torch.clamp_min(norms, 1e-9)
        if quantum is not None:
            return ((quantum * norms.float()) ** 2 + mask,
                    torch.full_like(mask, 2.0) * quantum)
        return norms.float() ** 2 + mask, torch.full_like(mask, 2.0)
    if metric == dist.COSINE:
        return mask, torch.full_like(mask, 2.0)
    return norms + mask, torch.full_like(mask, 2.0)


def scan_search(
    vectors: torch.Tensor,    # [cap, D] storage dtype
    norms: torch.Tensor,      # [cap] f32
    levels: torch.Tensor,     # [cap] int32 (-1 = unallocated)
    deleted: torch.Tensor,    # [cap] bool
    allow: Optional[torch.Tensor],   # [cap] bool or None
    q: torch.Tensor,          # [B, D] encoded queries
    qn: torch.Tensor,         # [B] f32 (int-domain query norms; zeros if n/a)
    k: int,
    *,
    metric: str,
    mode: str = "approx",
    fast: bool = False,
    quantum: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bias + scan top-k + distance map: the index's serving entry.

    On the kernel route the default f32 (and asymmetric int8) approximate
    read is a fast single-bf16-pass pass A for the candidates, then an
    exact f32 re-rank of those k candidates (`distance.gathered`)."""
    live = (levels >= 0) & ~deleted
    if allow is not None:
        live = live & allow
    asym = vectors.dtype == torch.int8 and q.dtype != torch.int8
    biasA, biasB = serving_bias(vectors, norms, live, metric,
                                quantum if asym else None)
    is_int8_sym = vectors.dtype == torch.int8 and not asym
    if _use_kernel(vectors):
        if mode != "exact" and not fast \
                and (vectors.dtype == torch.float32 or asym):
            _, rows = _scan_kernel(q, vectors, biasA, biasB, k, fast=True)
            d = dist.gathered(vectors, rows, q, metric, corpus_norms=norms,
                              query_norms=qn,
                              quantum=quantum if asym else None)
            d = torch.where(rows < 0, INF, d)
            d, order = torch.sort(d, dim=1, stable=True)
            rows = torch.gather(rows, 1, order)
            rows = torch.where(torch.isinf(d), -1, rows)
            return torch.clamp_min(d, 0.0), rows
        # a bf16 arena's pass A takes the query in bf16; the distances
        # below keep |q|^2 of the query as given
        qk = q.to(torch.bfloat16) if vectors.dtype == torch.bfloat16 else q
        s, rows = _scan_kernel(qk, vectors, biasA, biasB, k,
                               exact=mode == "exact", fast=fast)
    else:
        s, rows = _scan_blocked(q, vectors, biasA, biasB, k)
    d = scores_to_distances(s, q, qn, metric, is_int8_sym)
    d = torch.where(rows < 0, INF, torch.clamp_min(d, 0.0))
    return d, rows


def scores_to_distances(scores, q32, qn, metric: str, int8: bool):
    """Scan scores back to the metric's distances. L2: d^2 = score + |q|^2
    (quantized domain for int8); cosine: d = 1 + score / (2 |q|), |q| = 1
    for pre-normalized f32/bf16 queries."""
    if metric == dist.COSINE:
        if int8:
            return 1.0 + scores / (2.0 * torch.clamp_min(qn, 1e-9)[:, None])
        return 1.0 + scores / 2.0
    q2 = (qn ** 2)[:, None] if int8 else \
        torch.sum(q32.float() ** 2, dim=-1, keepdim=True)
    return scores + q2
