"""The two scan-probe kernels (ops/scan_probe.py) against the TPU kernels
they replace, run in TPU interpret mode on the CPU:

* `scan_vT` of scripts/matmul_ceiling.py, whose module runs an 8192^2
  product at import: its `kernel` and `scan_vT` definitions are taken out
  with `ast` and executed with small module constants;
* `scan_reduce` of scripts/scan_pallas_proto.py (`make_kernel`), imported
  by path with its module globals B, N, D set small.
The scripts are not edited. Each is held to the port's plain version
(`scan_vT_plain`, `scan_reduce_plain`, the CPU route of the wrappers) at
one (ST, G) with W = ST/G = 64 and one with W >= 128. Tolerance: gmin
within 1e-5 of |bias| + 2|q||v| (float32 sums of bf16 products in another
order); garg equal, or the two members' float64 scores within twice that
(a tie). The kernels themselves run only on the card (chip_smoke.py
holds them against the same plain versions).
"""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kektordb_tpu_torch.ops import scan_probe
from kektordb_tpu_torch.probes import matmul_ceiling, pass_b_ties, scan_proto

RTOL = 1e-5
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
B, D, N, BT = 32, 16, 2048, 16
CASES = [(512, 8), (1024, 8), (2048, 16)]       # W = 64, 128, 128


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    v32 = rng.normal(size=(N, D)).astype(np.float32)
    q32 = rng.normal(size=(B, D)).astype(np.float32)
    bias = (v32 ** 2).sum(1, dtype=np.float32)[None, :]
    return q32, v32, bias


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _scan_vT_reference(st, g):
    """The script's `kernel` and `scan_vT`, executed with small constants."""
    tree = ast.parse((SCRIPTS / "matmul_ceiling.py").read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("kernel", "scan_vT")]
    assert len(defs) == 2
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "np": np,
          "B": B, "D": D, "N": N, "BT": BT, "ST": st, "G": g, "W": st // g}
    exec(compile(ast.Module(body=defs, type_ignores=[]),
                 "matmul_ceiling.py", "exec"), ns)
    return ns["scan_vT"]


def _scan_reduce_reference(st, g):
    spec = importlib.util.spec_from_file_location(
        "_scan_pallas_proto_under_test", SCRIPTS / "scan_pallas_proto.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.N, mod.D = B, N, D
    return mod.make_kernel(BT, st, g)


def _check(got, want, q, v, bias, st, g):
    """got: the port's (gmin, garg) tensors; want: the TPU kernel's."""
    gp, ap = got[0].numpy(), got[1].numpy()
    gj, aj = np.asarray(want[0]), np.asarray(want[1])
    assert gp.shape == gj.shape == (B, N // g)
    qf = q.float().numpy().astype(np.float64)
    vf = v.float().numpy().astype(np.float64)
    scale = np.abs(bias).max() + 2 * np.linalg.norm(qf, axis=1).max() \
        * np.linalg.norm(vf, axis=1).max()
    tol = RTOL * scale
    assert np.abs(gp - gj).max() <= tol
    W = st // g
    b, p = np.nonzero(ap != aj)
    base = (p // W) * st + p % W
    s = bias[0].astype(np.float64)

    def score(rows):
        return s[rows] - 2.0 * np.einsum("ij,ij->i", qf[b], vf[rows])
    gap = np.abs(score(base + ap[b, p] * W) - score(base + aj[b, p] * W))
    assert gap.size == 0 or gap.max() <= 2 * tol


@pytest.mark.parametrize("st,g", CASES)
def test_scan_vT_matches_tpu_kernel(st, g):
    q32, v32, bias = _inputs(seed=st + g)
    qb, vb = _bf16(q32), _bf16(v32)
    fn = _scan_vT_reference(st, g)
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(fn(
            jnp.asarray(q32).astype(jnp.bfloat16),
            jnp.asarray(v32.T).astype(jnp.bfloat16), jnp.asarray(bias)))
    before = scan_probe.scan_vT.launches
    got = scan_probe.scan_vT(qb, vb.T.contiguous(), torch.from_numpy(bias),
                             st=st, g=g)
    assert scan_probe.scan_vT.launches == before       # CPU: plain route
    _check(got, want, qb, vb, bias, st, g)


@pytest.mark.parametrize("st,g", CASES)
def test_scan_reduce_matches_tpu_kernel(st, g):
    q32, v32, bias = _inputs(seed=st * g)
    qb, vb = _bf16(q32), _bf16(v32)
    fn = _scan_reduce_reference(st, g)
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(fn(
            jnp.asarray(q32).astype(jnp.bfloat16),
            jnp.asarray(v32).astype(jnp.bfloat16), jnp.asarray(bias)))
    before = scan_probe.scan_reduce.launches
    got = scan_probe.scan_reduce(qb, vb, torch.from_numpy(bias), st=st, g=g)
    assert scan_probe.scan_reduce.launches == before
    _check(got, want, qb, vb, bias, st, g)


def test_transposed_and_row_major_agree_on_a_ragged_arena():
    """The same function over both layouts, bit for bit, with a last tile
    cut short to 12 rows: groups 0-11 hold one row (member 0), groups
    12-63 none (+inf, where both give the last member)."""
    q32, v32, bias = _inputs(seed=3)
    n = N - 512 + 12
    qb, vb = _bf16(q32), _bf16(v32[:n])
    b = torch.from_numpy(bias[:, :n].copy())
    a = scan_probe.scan_vT(qb, vb.T.contiguous(), b, st=512, g=8)
    r = scan_probe.scan_reduce(qb, vb, b, st=512, g=8)
    torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert torch.isinf(a[0][:, -52:]).all() and (a[1][:, -52:] == 7).all()
    assert torch.isfinite(a[0][:, -64:-52]).all()
    assert (a[1][:, -64:-52] == 0).all()


def test_probes_run_on_the_cpu_untimed():
    mm = matmul_ceiling.run("cpu", M=32, B=16, D=8, Nc=64, K2=16, N2=16,
                            N=2048, ST=512, G=8)
    assert mm["device"] == "cpu"
    assert all(mm[k]["ms"] is None for k in ("square", "skinny", "fat",
                                              "scan_vT"))
    sp = scan_proto.run("cpu", B=16, N=4096, D=8,
                        tuples=((16, 512, 8), (16, 2048, 16)),
                        check=(16, 512, 8))
    assert [s["ms"] for s in sp["sweep"]] == [None, None]
    assert sp["check"]["garg_match"] == 1.0
    assert sp["check"]["gmin_err"] < 1e-4


def test_pass_b_ties_probe_runs_on_the_cpu_untimed(monkeypatch):
    """pass B's probe on the CPU: both tie-order designs (the port's
    repair and one int64-key topk) equal a stable sort on both of its
    minima, the tied one tying at the k-th place in most rows; nothing is
    timed; and by default it asks for the card."""
    rows = pass_b_ties.run("cpu", b=8, m=256)
    assert len(rows) == 12 and all(r["ms"] is None for r in rows)
    assert all(r["tied_rows"] >= 6 if r["gmin"] == "runs of 4 ties"
               else r["tied_rows"] == 0 for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pass_b_ties.run(b=8, m=256)


@pytest.mark.parametrize("probe", [matmul_ceiling.run, scan_proto.run])
def test_probes_default_to_the_card(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        probe(B=16, N=2048, D=8)


def test_bias_takes_the_scripts_shapes_only():
    """[1, N] (the scripts') or [N] float32; anything else raises."""
    with pytest.raises(ValueError):
        scan_probe._bias(torch.zeros((1, 5)), 6)
    with pytest.raises(ValueError):
        scan_probe._bias(torch.zeros(6, dtype=torch.float64), 6)
    assert scan_probe._bias(torch.zeros((1, 6)), 6).shape == (6,)
    assert scan_probe._bias(torch.zeros(6), 6).shape == (6,)


def test_timer_gives_no_card_time_on_the_cpu():
    """The device-only timer runs the call once off the card and returns
    no time (a CPU time is never reported as the card's)."""
    from kektordb_tpu_torch import probes
    calls = []
    assert probes.timed(torch.device("cpu"), lambda: calls.append(1),
                        5) is None
    assert probes.device_ms(torch.device("cpu"), lambda: calls.append(1),
                            5) is None
    assert calls == [1, 1]
    assert probes.rate(None, 1.0).startswith("not timed")
