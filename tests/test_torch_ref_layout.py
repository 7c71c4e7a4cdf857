"""The JAX package's tests/test_layout.py, every case, run against the
port's optimize_layout (test_torch_port_reference)."""

from test_torch_port_reference import reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_layout.py"), "test_layout.py", "exec"))
