"""The JAX package's tests/test_http.py, every case, run against the port's
server over an Engine on DEVICE (test_torch_port_reference), with 8
devices visible for its sharded cases."""

from test_torch_port_reference import (reference_cases, repeat_devices,
                                       torch_threads)

_devices = repeat_devices(8)   # the reference conftest's 8 devices
_threads = torch_threads(1)

exec(compile(reference_cases("test_http.py"), "test_http.py", "exec"))
