"""A run with its timed path broken underneath, the harness's look for a
card skipped, at a small size on the CPU: ``correct`` has to come out false
for every fault a training cell can have on one chip (a step that leaves
its state unchanged; half of the batch left out, the mean over the rest),
and true for the sound program. Every cell of ``BENCHMARK.json``."""

import pytest
import torch

import run
from conftest import WORKLOADS, small_cell


@pytest.mark.parametrize("cell", sorted(WORKLOADS))
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_correct_sees_the_fault(cell, fault):
    out = run.measure(small_cell(cell), 2**31 + 77, 0.1, False, torch.device("cpu"),
                      fault=fault)
    assert out["correct"] is (fault is None), out["checks"]
