"""The JAX package's tests/test_hnsw.py, run against the port's HNSWIndex
(test_torch_port_reference): every case but the nav table's, a TPU
workaround the port does not keep (see NOT_TRANSPOSED)."""

from test_torch_port_reference import reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_hnsw.py",
                             but=["test_nav_table_beam_serving"]),
             "test_hnsw.py", "exec"))
