"""The JAX package's tests/test_scan.py against the port's scan serving
(ops/scan.py, HNSWIndex serve_mode="scan", the projected scan).

* Every case but TestScanTopk runs as it is (test_torch_port_reference).
* TestScanTopk feeds `jnp` arrays to the op-level functions: each of its
  cases is the reference's under its own name, with its assertions and
  tolerances, on torch tensors on DEVICE. The reference's Pallas pass A
  in interpret mode is the port's pass A (`scan._scan_kernel`): its plain
  version on the CPU, the kernel on the card.
"""

import numpy as np
import torch
from test_torch_port_reference import DEVICE, reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_scan.py", but=["TestScanTopk"]),
             "test_scan.py", "exec"))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=DEVICE)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _ones(n: int) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=DEVICE)


class TestScanTopk:
    def test_xla_fallback_matches_oracle_l2(self):
        N, D, B = 4096, 32, 64
        X, Q = data(N, D), data(B, D, seed=1)
        v = _t(X)
        live = _ones(N)
        v2 = torch.sum(v.float() ** 2, dim=-1)
        biasA, biasB = scan.serving_bias(v, v2, live, dist.L2)
        s, rows = scan.scan_topk(_t(Q), v, biasA, biasB, 10)
        d = scan.scores_to_distances(s, _t(Q), None, dist.L2, False)
        gd, gi = dist.brute_force_topk(_t(Q), v, 10, dist.L2)
        np.testing.assert_array_equal(_np(rows), _np(gi))
        np.testing.assert_allclose(_np(d), _np(gd), rtol=1e-4, atol=1e-3)

    def test_pallas_kernel_interpret_parity(self):
        """Pass-A kernel logic (group min/argmin + index reconstruction):
        the port's pass A, plain on the CPU, the kernel on the card."""
        N, D, B = 2048, 32, 32
        X, Q = data(N, D), data(B, D, seed=2)
        v = _t(X)
        live = _ones(N)
        v2 = torch.sum(v.float() ** 2, dim=-1)
        biasA, biasB = scan.serving_bias(v, v2, live, dist.L2)
        s, rows = scan._scan_kernel(_t(Q), v, biasA, biasB, 10, exact=True)
        gd, gi = dist.brute_force_topk(_t(Q), v, 10, dist.L2)
        gi_np, rows_np = _np(gi), _np(rows)
        # group collisions (two true top-10 rows in one G-group) shift a
        # few slots at this tiny N — overlap, not equality
        overlap = np.mean([len(set(gi_np[b]) & set(rows_np[b])) / 10
                           for b in range(B)])
        assert overlap >= 0.9
        # every returned row's distance must be its true exact distance
        d = scan.scores_to_distances(s, _t(Q), None, dist.L2, False)
        true_d = ((Q[:, None, :] - X[rows_np]) ** 2).sum(-1)
        np.testing.assert_allclose(_np(d), true_d, rtol=1e-3, atol=1e-2)

    def test_mask_excludes_rows(self):
        N, D, B = 2048, 16, 32
        X, Q = data(N, D), data(B, D, seed=3)
        v = _t(X)
        live = _ones(N)
        live[: N // 2] = False
        v2 = torch.sum(v.float() ** 2, dim=-1)
        biasA, biasB = scan.serving_bias(v, v2, live, dist.L2)
        s, rows = scan.scan_topk(_t(Q), v, biasA, biasB, 10)
        assert (_np(rows) >= N // 2).all()

    def test_cosine(self):
        N, D, B = 2048, 24, 32
        X = _np(dist.normalize(_t(data(N, D))))
        Q = _np(dist.normalize(_t(data(B, D, seed=4))))
        v = _t(X)
        live = _ones(N)
        biasA, biasB = scan.serving_bias(
            v, torch.zeros((N,), device=DEVICE), live, dist.COSINE)
        s, rows = scan.scan_topk(_t(Q), v, biasA, biasB, 10)
        d = scan.scores_to_distances(s, _t(Q), None, dist.COSINE, False)
        gd, gi = dist.brute_force_topk(_t(Q), v, 10, dist.COSINE)
        np.testing.assert_array_equal(_np(rows), _np(gi))
        np.testing.assert_allclose(_np(d), _np(gd), rtol=1e-3, atol=1e-3)

    def test_int8_cosine(self):
        from kektordb_tpu_torch.ops import quantize as quant
        N, D, B = 2048, 32, 32
        X = _np(dist.normalize(_t(data(N, D))))
        Q = _np(dist.normalize(_t(data(B, D, seed=5))))
        qs = quant.train(_t(X))
        codes, norms = quant.quantize(qs, _t(X))
        qcodes, qnorms = quant.quantize(qs, _t(Q))
        live = _ones(N)
        biasA, biasB = scan.serving_bias(codes, norms, live, dist.COSINE)
        s, rows = scan.scan_topk(qcodes, codes, biasA, biasB, 10)
        d = scan.scores_to_distances(s, qcodes, qnorms, dist.COSINE, True)
        gd, gi = dist.brute_force_topk(_t(Q), _t(X), 10, dist.COSINE)
        # quantized-domain rank parity vs f32 oracle: near-exact
        gi_np, rows_np = _np(gi), _np(rows)
        overlap = np.mean([len(set(gi_np[b]) & set(rows_np[b])) / 10
                           for b in range(B)])
        assert overlap >= 0.9
        assert float(np.abs(_np(d)[:, 0] - _np(gd)[:, 0]).max()) < 0.05
