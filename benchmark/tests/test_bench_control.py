"""The precision control, the plain reference computed in bfloat16 and put
in the program's place, comes out as not correct in every cell, and the
program on the same streams as correct (the CPU at a tiny size; on the
card, at the cells' sizes, ``benchmark/calibrate.py``)."""

import pytest
import torch

from benchmark import calibrate

from .test_bench_harness import CELLS, tiny


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    (r,) = calibrate.readings(name, [2 ** 31 + 3], 1, 0.0,
                              torch.device("cpu"), patch=tiny)
    assert r["program_correct"] is True, r
    assert r["control_correct"] is False, r
