"""Gate-level operation counts and the card's peaks: the yardstick of
``step_mfu``.

The work is counted from the circuit's gate list, whatever implements it,
so that no redesign of a kernel or of the step changes the count:

- a dense one-qubit gate is its 2x2 complex product on every amplitude pair:
  two complex multiply-adds an amplitude;
- a diagonal gate (a phase) counts one complex multiply on each amplitude
  it changes: all of them for a one-qubit phase, the quarter where both
  bits are 1 for CZ;
- a complex multiply-add is 8 real operations, a complex multiply 6;
- the <Z_w> readout is |a|^2 (3) and a multiply-add (2) a wire on every
  amplitude; a dense layer is 2 operations a multiply-add.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

CMAC, CMUL = 8, 6

# NVIDIA H100 SXM, dense, from NVIDIA's data sheet (700 W)
PEAK_FP32 = 67e12  # outside the tensor cores
PEAK_TF32 = 495e12
PEAK_3XTF32 = PEAK_TF32 / 3  # three TF32 products make one f32-accurate one


def gate_flops(kind: str, n: int) -> int:
    """Real operations of one gate on one row of 2^n amplitudes."""
    d = 1 << n
    if kind == "1q":
        return 2 * CMAC * d
    if kind == "diag":
        return CMUL * d
    if kind == "cz":
        return CMUL * d // 4
    raise ValueError(f"unknown gate kind {kind!r}")


def circuit_flops(gates: Iterable[Tuple[str, tuple]], n: int) -> int:
    return sum(gate_flops(kind, n) for kind, _ in gates)


def readout_flops(n: int) -> int:
    return (3 + 2 * n) * (1 << n)


def mlp_flops(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
