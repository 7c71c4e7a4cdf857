"""The JAX package's tests/test_hostarena.py, every case, run against the
port's HostArenaIndex and its Engine route (test_torch_port_reference)."""

from test_torch_port_reference import reference_cases, torch_threads

_threads = torch_threads(1)

exec(compile(reference_cases("test_hostarena.py"),
             "test_hostarena.py", "exec"))
