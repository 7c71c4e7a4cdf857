"""The JAX package's tests/test_engine.py, every case, run against the
port's Engine (test_torch_port_reference)."""

from test_torch_port_reference import reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_engine.py"), "test_engine.py", "exec"))
