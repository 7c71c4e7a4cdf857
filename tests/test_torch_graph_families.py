"""Graph build and beam serving in the other precision families: the same
add_batch / delete / beam search / run_maintenance_cycle (vacuum with
graph healing) / beam search sequence on the same seeded data gives the
same rows in both packages (at least 99% of entries: near-ties may swap)
and distances within rtol 1e-5, with an absolute floor of 1e-4 for
cancellation near zero. int8 arenas take the symmetric beam (int8 query,
integer-domain distances, torch ops in the port); bf16 and f32 the
gather-distance step."""

import numpy as np
import pytest
import torch

from kektordb_tpu.index import HNSWConfig as JConfig
from kektordb_tpu.index import HNSWIndex as JIndex
from kektordb_tpu_torch.index import HNSWConfig, HNSWIndex

N, D = 1200, 32
FAMILIES = [("cosine", "int8"), ("euclidean", "bfloat16"),
            ("cosine", "float32")]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def sequence(idx, X, Q):
    idx.add_batch([f"v{i}" for i in range(N)], X)
    for i in range(0, N, 10):
        idx.delete(f"v{i}")
    out = [idx.search(Q, 10, mode="beam")]
    cycle = idx.run_maintenance_cycle()
    out.append(idx.search(Q, 10, mode="beam"))
    return cycle, out


@pytest.mark.parametrize("metric,precision", FAMILIES,
                         ids=[f"{m}-{p}" for m, p in FAMILIES])
def test_family_beam_sequence_same_rows(metric, precision):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Q = rng.normal(size=(40, D)).astype(np.float32)
    kw = dict(m=8, ef_construction=48, ef_search=48, chunk=256)
    ref = JIndex(D, metric, precision, config=JConfig(**kw))
    port = HNSWIndex(D, metric, precision, config=HNSWConfig(**kw),
                     device="cpu")
    (jc, jout), (tc, tout) = sequence(ref, X, Q), sequence(port, X, Q)
    assert jc == tc == "vacuum"
    for (jd, ji), (td, ti) in zip(jout, tout):
        ji, jd = np.asarray(ji), np.asarray(jd)
        assert np.mean(ji == ti) >= 0.99
        eq = (ji == ti) & (ji >= 0)
        np.testing.assert_allclose(td[eq], jd[eq], rtol=1e-5, atol=1e-4)
        assert not np.isin(ti, np.arange(0, N, 10)).any()
