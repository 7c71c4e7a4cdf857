"""The JAX package's tests/test_distributed.py, run against the port's
ReplicatedServing (test_torch_port_reference) with 8 devices visible: the
single-process cases. Its two-process cases start JAX workers; see
NOT_TRANSPOSED."""

from test_torch_port_reference import (reference_cases, repeat_devices,
                                       torch_threads)

_devices = repeat_devices(8)   # the reference conftest's 8 devices
_threads = torch_threads(1)

exec(compile(reference_cases("test_distributed.py",
                             ["setup", "TestReplicatedServing"]),
             "test_distributed.py", "exec"))
