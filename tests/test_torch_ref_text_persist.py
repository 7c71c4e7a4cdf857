"""The JAX package's tests/test_text_persist.py, run against the port's text
analysis, BM25 and journal (test_torch_port_reference): every case but
TestBM25, which tests/test_torch_text_persist.py runs."""

from test_torch_port_reference import reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_text_persist.py", but=["TestBM25"]),
             "test_text_persist.py", "exec"))
