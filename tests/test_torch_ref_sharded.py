"""The JAX package's tests/test_sharded.py, run against the port's
ShardedHNSW (test_torch_port_reference) with 8 devices visible: every case
but the two that read the stacked TPU state the port does not keep (see
NOT_TRANSPOSED)."""

from test_torch_port_reference import (reference_cases, repeat_devices,
                                       torch_threads)

_devices = repeat_devices(8)   # the reference conftest's 8 devices
_threads = torch_threads(1)

exec(compile(reference_cases("test_sharded.py", but=[
    "test_mesh_residency", "test_capacity_scales_linearly_with_devices"]),
             "test_sharded.py", "exec"))
