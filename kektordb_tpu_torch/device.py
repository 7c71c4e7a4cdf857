"""Device selection, dtypes and float32 precision for the PyTorch port.

Precision. The JAX package asks for `Precision.HIGHEST` wherever a float32
product has to be exact: the exact scan, the brute-force oracle and the
re-rank of the fused scan's candidates (`distance.gathered`). On an NVIDIA
card a float32 product is full float32 only while TF32 is off: TF32 keeps
10 mantissa bits, which reorders near-ties in the re-rank and breaks the
oracle. So both TF32 switches are turned off here, once, when the port is
imported. Every module of the port imports this one.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# precision name (ops.distance.PRECISIONS) -> arena dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def resolve(device="cuda") -> torch.device:
    """The device an index or engine runs on. "cuda" is the default and
    raises when PyTorch sees no card: a CUDA index never runs on the CPU
    by accident. The CPU is chosen explicitly (tests pass "cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def from_numpy(a, device) -> torch.Tensor:
    """numpy array, scalar or tensor -> tensor on `device`. bfloat16 arrays
    from JAX (ml_dtypes) have no torch counterpart in `from_numpy`: they
    cross as their uint16 bit pattern. The data is copied: the tensor is
    written in place later, and arrays fetched from JAX are read-only."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)
