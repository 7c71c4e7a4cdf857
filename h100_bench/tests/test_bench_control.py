"""The control, the plain reference in TF32 put in the program's place,
comes out as not correct by the cell's own limits (on the CPU TF32 is
emulated by rounding the product's inputs to 10 mantissa bits)."""

import pytest
from bench_small import SMALL

import control


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("seed", [11, 2**32 + 5])
def test_control_is_not_correct(workload, seed):
    got = control.control_numbers(workload, seed, 2000, "cpu",
                                  SMALL[workload])
    assert not got["correct"], got
    assert got["bad_answers"] == 0 and got["unanswered"] == 0
