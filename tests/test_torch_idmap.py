"""The port's IDMap (index/base.py), the host-side ext <-> row map and
its vectorized mirror (the JAX package's tests/test_idmap.py).

* The reference's three cases run against the port (its source read,
  every `kektordb_tpu` module made the port's).
* The same seeded sequence of allocs, releases and unmaps goes through
  both packages' IDMap: the same rows, the same mirror (`exts_array`),
  the same live mask and version at every step.
"""

import numpy as np
import pytest
from test_torch_port_reference import reference_cases

from kektordb_tpu.index.base import IDMap as JIDMap
from kektordb_tpu_torch.index.base import IDMap

exec(compile(reference_cases("test_idmap.py"), "test_idmap.py", "exec"))


def _walk(cls, seed: int, steps: int = 3000) -> list:
    """Seeded mutations of one IDMap; what each step returns and shows."""
    rng = np.random.default_rng(seed)
    m = cls()
    live: list[str] = []
    seen = []
    n = 0
    for step in range(steps):
        op = rng.integers(0, 10)
        if op < 6 or not live:
            ext = f"x{n}"
            n += 1
            got = m.alloc(ext)
            live.append(ext)
        else:
            ext = live.pop(int(rng.integers(0, len(live))))
            got = m.release(ext) if op < 9 else m.unmap(ext)
        seen.append(got)
        if step % 250 == 0 or step == steps - 1:
            cap = m.capacity_used
            seen.append((cap, len(m), m.version,
                         m.exts_array()[:cap].tolist(),
                         m.live_mask(cap + 3).tolist(),
                         m.exts_of(list(range(cap)))))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_mutations_agree_with_reference(seed):
    assert _walk(IDMap, seed) == _walk(JIDMap, seed)
