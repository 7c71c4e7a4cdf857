"""The JAX package's tests/test_int8_asym.py against the port's
asymmetric and symmetric int8 serving, with 8 devices visible for its
sharded case.

* `test_sharded_search_device_symmetric_rescale` and
  `test_beam_mode_stays_symmetric` run as they are
  (test_torch_port_reference).
* The other four cases of TestAsymmetricScan build their data or their
  oracle with `jnp`: each is the reference's under its own name, with its
  assertions and tolerances, on torch tensors on DEVICE. Two of them are
  index-level (`compress_serving("int8")` and `int8_symmetric`) and take
  only their oracle from the op.
"""

import numpy as np
import torch
from test_torch_port_reference import (DEVICE, reference_cases, repeat_devices,
                                       torch_threads)

_devices = repeat_devices(8)   # the reference conftest's 8 devices
_threads = torch_threads(1)

exec(compile(reference_cases("test_int8_asym.py", [
    "clustered", "recall_at",
    "TestAsymmetricScan.test_sharded_search_device_symmetric_rescale",
    "TestAsymmetricScan.test_beam_mode_stays_symmetric"]),
    "test_int8_asym.py", "exec"))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=DEVICE)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class TestAsymmetricScan(TestAsymmetricScan):  # noqa: F821
    def _setup(self, metric, n=4096, d=64, nq=64):
        X = clustered(n + nq, d)
        base, q = X[:n], X[n:]
        if metric == dist.COSINE:
            base = base / np.linalg.norm(base, axis=1, keepdims=True)
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        qz = quant.train(_t(base))
        codes, cnorms = quant.quantize(qz, _t(base))
        levels = torch.zeros((n,), dtype=torch.int32, device=DEVICE)
        deleted = torch.zeros((n,), dtype=torch.bool, device=DEVICE)
        gt_d, gt_rows = dist.brute_force_topk(_t(q), _t(base), 10, metric)
        return base, q, qz, codes, cnorms, levels, deleted, \
            _np(gt_rows), _np(gt_d)

    def test_asym_beats_symmetric_cosine(self):
        base, q, qz, codes, cnorms, levels, deleted, gt_rows, _ = \
            self._setup(dist.COSINE)
        # symmetric: quantized query
        qc, qn_int = quant.quantize(qz, _t(q))
        _, sym_rows = scanlib.scan_search(
            codes, cnorms, levels, deleted, None, qc, qn_int, 10,
            metric=dist.COSINE)
        # asymmetric: float query (pre-normalized), quantum for L2 only
        qf = _t(q)
        _, asym_rows = scanlib.scan_search(
            codes, cnorms, levels, deleted, None, qf,
            torch.ones((q.shape[0],), device=DEVICE), 10,
            metric=dist.COSINE, quantum=qz.abs_max / 127.0)
        r_sym = recall_at(_np(sym_rows), gt_rows)
        r_asym = recall_at(_np(asym_rows), gt_rows)
        assert r_asym >= r_sym - 1e-9
        assert r_asym >= 0.97

    def test_asym_l2_distances_real_domain(self):
        base, q, qz, codes, cnorms, levels, deleted, gt_rows, gt_d = \
            self._setup(dist.L2)
        qf = _t(q)
        d_asym, rows = scanlib.scan_search(
            codes, cnorms, levels, deleted, None, qf,
            torch.zeros((q.shape[0],), device=DEVICE), 10, metric=dist.L2,
            quantum=qz.abs_max / 127.0)
        d_asym, rows = _np(d_asym), _np(rows)
        # distances must approximate REAL-domain squared L2 (no rescale):
        # compare the top hit's distance against the exact value for the
        # same row — error bounded by corpus quantization only
        v = base[rows[:, 0]]
        exact = np.sum((q - v) ** 2, axis=1)
        denom = np.maximum(exact, 1e-3)
        assert np.median(np.abs(d_asym[:, 0] - exact) / denom) < 0.05
        assert recall_at(rows, gt_rows) >= 0.95

    def test_index_level_int8_compress_asym(self):
        """compress_serving('int8') on a cosine index: search distances in
        [0, 2], recall vs f32 GT >= 0.95, and search_device scale == 1."""
        n, d = 2048, 48
        X = clustered(n + 32, d)
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        base, q = X[:n], X[n:]
        idx = HNSWIndex(d, dist.COSINE,
                        config=HNSWConfig(m=8, serve_mode="scan"),
                        device=DEVICE)
        idx.add_batch([f"v{i}" for i in range(n)], base, link=False)
        _, gt_rows = dist.brute_force_topk(_t(q), _t(base), 10, dist.COSINE)
        idx.compress_serving("int8")
        dd, rr = idx.search(q, 10)
        assert recall_at(np.asarray(rr), _np(gt_rows)) >= 0.95
        assert float(np.nanmax(np.where(np.isfinite(dd), dd, 0))) <= 2.01
        res = idx.search_device(q, 10)
        assert res is not None and res[2] == 1.0

    def test_int8_symmetric_knob(self):
        """config.int8_symmetric=True restores the reference's symmetric
        int-domain scoring (the max-QPS operating point): scan results
        stay sane on cosine, and an L2 compress_serving('int8') index
        returns REAL-domain distances under both modes (symmetric scan
        rescales; search_device hands the fuser the scale)."""
        n, d = 2048, 48
        X = clustered(n + 32, d)
        Xc = X / np.linalg.norm(X, axis=1, keepdims=True)
        base, q = Xc[:n], Xc[n:]
        idx = HNSWIndex(d, dist.COSINE, precision=dist.INT8,
                        config=HNSWConfig(m=8, serve_mode="scan"),
                        device=DEVICE)
        idx.add_batch([f"v{i}" for i in range(n)], base, link=False)
        _, gt_rows = dist.brute_force_topk(_t(q), _t(base), 10, dist.COSINE)
        d_a, r_a = idx.search(q, 10)               # asym (default)
        idx.config.int8_symmetric = True
        d_s, r_s = idx.search(q, 10)               # symmetric
        idx.config.int8_symmetric = False
        rec_a = recall_at(np.asarray(r_a), _np(gt_rows))
        rec_s = recall_at(np.asarray(r_s), _np(gt_rows))
        assert rec_s >= 0.85                        # sane, reference-like
        assert rec_a >= rec_s - 0.02                # asym never worse

        # L2 via compress_serving: symmetric distances rescale to real
        base2, q2 = X[:n], X[n:]
        idx2 = HNSWIndex(d, dist.L2,
                         config=HNSWConfig(m=8, serve_mode="scan"),
                         device=DEVICE)
        idx2.add_batch([f"w{i}" for i in range(n)], base2, link=False)
        idx2.compress_serving("int8")
        d_a2, _ = idx2.search(q2, 5)
        idx2.config.int8_symmetric = True
        d_s2, _ = idx2.search(q2, 5)
        res = idx2.search_device(q2, 5)
        assert res is not None and res[2] != 1.0    # fuser gets the scale
        idx2.config.int8_symmetric = False
        # same domain: top-1 distances agree to quantization error
        a, s = np.asarray(d_a2)[:, 0], np.asarray(d_s2)[:, 0]
        fin = np.isfinite(a) & np.isfinite(s)
        assert np.allclose(a[fin], s[fin],
                           rtol=0.25, atol=0.05 * float(a[fin].mean()))
