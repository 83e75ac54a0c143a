"""The control, on the card: the plain reference computed with TF32 on (the
nearest precision below the configurations' float32 with TF32 off) in the
program's place has to come out as not correct, while the program itself
comes out correct. Every cell of ``BENCHMARK.json``, at its ``on_card``
test sizes (``sizes/``); the cell's own size is ``calibrate.py``'s (its
readings are in PERF.md)."""

import pytest
import torch

from conftest import WORKLOADS, small_cell
from lib import compare
from lib.spec import system


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_tf32_reference_is_not_correct(card, name, seed):
    cell = small_cell(name, "on_card")
    torch.backends.cuda.matmul.allow_tf32 = False
    s = system(cell.traffic).build(cell.config, cell.traffic, seed, card)
    prog = s.compared_steps()
    s.free()
    ref = s.reference(card)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = s.reference(card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert compare.judge(compare.gaps(prog, ref), cell.limits), compare.gaps(prog, ref)
    assert not compare.judge(compare.gaps(low, ref), cell.limits), compare.gaps(low, ref)
