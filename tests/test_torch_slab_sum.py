"""The fixed-order slab sum (K2b, K6b, K4b): the three plain versions add
slab 0, 1, ..., G-1 in order, bit for bit as the CUDA kernel
(qcpinn_tpu_torch/ops/csrc/slab_sum.cuh) and as the JAX package's
``+=`` over a sequential grid; and the kernel sources share that one loop.
"""

import os
import re

import numpy as np
import pytest
import torch

from qcpinn_tpu_torch.ops import block_kernel as bk
from qcpinn_tpu_torch.ops import loop_kernel as lk
from qcpinn_tpu_torch.ops import sv_kernel as sk

CSRC = os.path.join(os.path.dirname(lk.__file__), "csrc")


@pytest.mark.parametrize("g", [1, 2, 15, 132])
@pytest.mark.parametrize("slab", [1, 3, 4, 4099])
def test_plain_slab_sums_add_in_slab_order(g, slab):
    parts = np.random.default_rng(g * 7919 + slab).normal(size=(g, slab)).astype(np.float32)
    want = parts[0].copy()
    for c in range(1, g):
        want += parts[c]  # float32 adds, in slab order
    t = torch.from_numpy(parts.copy())
    outs = [bk.block_chain_reduce(t), lk.gate_loop_reduce(t), sk.unrolled_reduce(t)]
    for out in outs:
        assert out.dtype == torch.float32 and tuple(out.shape) == (slab,)
        assert torch.equal(out, outs[0])
        np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), parts)  # the partials are left as they were


def test_backwards_share_the_one_slab_sum():
    def read(name):
        with open(os.path.join(CSRC, name)) as f:
            return f.read()

    # a loop that adds partials[c * slab + e] over c < G
    old_loop = re.compile(r"for \(int c = \w+; c < G;|partials\[\(size_t\)c \* slab")
    shared = read("slab_sum.cuh")
    assert old_loop.search(shared) and "static int slab_sum_launch(" in shared
    for name in ("block_chain.cu", "gate_loop.cu", "unrolled_sv.cu"):
        src = read(name)
        assert '#include "slab_sum.cuh"' in src, name
        entry = re.search(r'extern "C" int qc_\w+_reduce\([^)]*\) \{(.*?)\n\}', src, re.S)
        assert entry and "return slab_sum_launch(partials, out, slab, G, stream);" in entry.group(1)
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")) and name != "slab_sum.cuh":
            src = read(name)
            assert not old_loop.search(src), name
            assert "slab_sum_kernel" not in src and "reduce_kernel" not in src, name
