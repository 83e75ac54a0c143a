"""The six DV ansatzes as gate-program builders.

Gate *orders* (including reversed loops and ring-closure order) match the
reference exactly, since they determine the circuit unitary:
cascade/layered/alternate/farhi/sim_circ_15/cross_mesh at
nn/DVQuantumLayer.py:246-371. Parameter counts per layer:

  layered     4n          alternate   4n - 4      cascade    3n
  farhi       2n - 2      sim_circ_15 2n          cross_mesh 4n + n(n-1)

plus ``rot_ring`` (3n, the StronglyEntangling-style Rot+CNOT ring of the
standalone trainer, trainer/train.py:208-218).

Known reference defect (documented in SURVEY.md §7.4, not reproduced): for
*even* n the reference's ``alternate`` loop emits n blocks (4n params) while
allocating only 4n-4, crashing on index overflow. We emit blocks only while
parameters remain (n-1 blocks), which matches the reference exactly for odd
n and makes even n usable.

The PyTorch port keeps this copy of ``qcpinn_tpu/ops/ansatz.py`` (pure
Python) because it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

from .program import Op, Program


def layered(n: int) -> Program:
    """nn/DVQuantumLayer.py:246-262 — RZ-RX per qubit, CNOT ring, RX-RZ."""
    ops: List[Op] = []
    p = 0
    for q in range(n):
        ops.append(Op("rz", (q,), (p,)))
        p += 1
        ops.append(Op("rx", (q,), (p,)))
        p += 1
    for q in range(n):
        ops.append(Op("cnot", (q, (q + 1) % n)))
    for q in range(n):
        ops.append(Op("rx", (q,), (p,)))
        p += 1
        ops.append(Op("rz", (q,), (p,)))
        p += 1
    assert p == 4 * n
    return tuple(ops)


def alternate(n: int) -> Program:
    """nn/DVQuantumLayer.py:264-285 — TDCNOT blocks on even then odd pairs."""
    ops: List[Op] = []
    p = 0
    budget = 4 * n - 4

    def tdcnot(ctrl: int, tgt: int):
        nonlocal p
        ops.append(Op("ry", (ctrl,), (p,)))
        p += 1
        ops.append(Op("ry", (tgt,), (p,)))
        p += 1
        ops.append(Op("cnot", (ctrl, tgt)))
        ops.append(Op("rz", (ctrl,), (p,)))
        p += 1
        ops.append(Op("rz", (tgt,), (p,)))
        p += 1

    pairs = [(i, (i + 1) % n) for i in range(n - 1)[::2]]
    pairs += [(i, (i + 1) % n) for i in list(range(n))[1::2]]
    for ctrl, tgt in pairs:
        if p + 4 > budget:  # see module docstring: reference overflows here
            break
        tdcnot(ctrl, tgt)
    assert p == budget, (p, budget)
    return tuple(ops)


def cascade(n: int) -> Program:
    """nn/DVQuantumLayer.py:287-305 — RX layer, RZ layer, CRX cascade ring."""
    ops: List[Op] = []
    p = 0
    for q in range(n):
        ops.append(Op("rx", (q,), (p,)))
        p += 1
    for q in range(n):
        ops.append(Op("rz", (q,), (p,)))
        p += 1
    ops.append(Op("crx", (n - 1, 0), (p,)))
    p += 1
    for q in reversed(range(1, n)):
        ops.append(Op("crx", (q - 1, q), (p,)))
        p += 1
    assert p == 3 * n
    return tuple(ops)


def farhi(n: int) -> Program:
    """nn/DVQuantumLayer.py:307-324 — RXX then RZX hub-and-spoke from the
    last qubit, each compiled as CNOT . R(wires[0]) . CNOT."""
    ops: List[Op] = []
    p = 0
    for i in range(n - 1):  # RXX(theta, [n-1, i])
        ops.append(Op("cnot", (n - 1, i)))
        ops.append(Op("rx", (n - 1,), (p,)))
        p += 1
        ops.append(Op("cnot", (n - 1, i)))
    for i in range(n - 1):  # RZX(theta, [n-1, i])
        ops.append(Op("cnot", (n - 1, i)))
        ops.append(Op("rz", (n - 1,), (p,)))
        p += 1
        ops.append(Op("cnot", (n - 1, i)))
    assert p == 2 * n - 2
    return tuple(ops)


def sim_circ_15(n: int) -> Program:
    """nn/DVQuantumLayer.py:326-346 — RY layer, reversed CNOT ring, RY layer,
    cross CNOT layer with ctrl=(i+n-1)%n, tgt=(ctrl+3)%n."""
    ops: List[Op] = []
    p = 0
    for q in range(n):
        ops.append(Op("ry", (q,), (p,)))
        p += 1
    for i in reversed(range(n)):
        ops.append(Op("cnot", (i, (i + 1) % n)))
    for q in range(n):
        ops.append(Op("ry", (q,), (p,)))
        p += 1
    for i in range(n):
        ctrl = (i + n - 1) % n
        tgt = (ctrl + 3) % n
        # For n == 3 the reference computes tgt == ctrl (a self-CNOT, which
        # crashes PennyLane too); skip the degenerate gates — block 2 is then
        # the identity. Matches the reference wherever the reference runs.
        if tgt != ctrl:
            ops.append(Op("cnot", (ctrl, tgt)))
    assert p == 2 * n
    return tuple(ops)


def cross_mesh(n: int) -> Program:
    """nn/DVQuantumLayer.py:348-371 — RX,RZ layers; all-to-all CRZ in double
    reversed order; RX,RZ layers."""
    ops: List[Op] = []
    p = 0
    for q in range(n):
        ops.append(Op("rx", (q,), (p,)))
        p += 1
    for q in range(n):
        ops.append(Op("rz", (q,), (p,)))
        p += 1
    for i in range(n - 1, -1, -1):
        for j in range(n - 1, -1, -1):
            if j != i:
                ops.append(Op("crz", (i, j), (p,)))
                p += 1
    for q in range(n):
        ops.append(Op("rx", (q,), (p,)))
        p += 1
    for q in range(n):
        ops.append(Op("rz", (q,), (p,)))
        p += 1
    assert p == 4 * n + n * (n - 1)
    return tuple(ops)


def rot_ring(n: int) -> Program:
    """StronglyEntangling-style Rot+CNOT ring
    (trainer/train.py:208-218): per layer, Rot(phi, theta, omega) on every
    qubit, then a CNOT ring [i, (i+1)%n]. 3n params per layer (weight
    shape (L, n, 3), trainer/train.py:223). The reference pairs this with
    the pi-scaled RX encoding (``encoding="angle_pi"``,
    trainer/train.py:205-207); the builder itself is encoding-agnostic.
    Also the AngleEmbedding+StronglyEntanglingLayers prototype circuit
    shape (hybrid_testing/CG_HQPINN_IBMtest.py:65-69)."""
    ops: List[Op] = []
    p = 0
    for q in range(n):
        ops.append(Op("rot", (q,), (p, p + 1, p + 2)))
        p += 3
    for q in range(n):
        ops.append(Op("cnot", (q, (q + 1) % n)))
    assert p == 3 * n
    return tuple(ops)


def reupload_cz_brickwork(n: int, layer: int) -> Program:
    """One layer of the 16-qubit Czochralski data-reuploading circuit
    (CG_HQPINN_IBMtest_16qubits.py:217-235), *excluding* the input-dependent
    RZ(0.5 * x[(i+layer)%n]) reupload (handled by the model with batched
    params). Per layer: Rot per qubit, even/odd CZ brickwork, ring closure.
    ``layer`` only affects the reupload indices, not this program.
    """
    del layer
    ops: List[Op] = []
    p = 0
    for q in range(n):
        ops.append(Op("rot", (q,), (p, p + 1, p + 2)))
        p += 3
    for i in range(0, n - 1, 2):
        ops.append(Op("cz", (i, i + 1)))
    for i in range(1, n - 1, 2):
        ops.append(Op("cz", (i, i + 1)))
    ops.append(Op("cz", (n - 1, 0)))
    return tuple(ops)


BUILDERS: Dict[str, callable] = {
    "layered": layered,
    "alternate": alternate,
    "cascade": cascade,
    "farhi": farhi,
    "sim_circ_15": sim_circ_15,
    "cross_mesh": cross_mesh,
    "rot_ring": rot_ring,
}

PARAM_COUNTS = {
    "layered": lambda n: 4 * n,
    "alternate": lambda n: 4 * n - 4,
    "cascade": lambda n: 3 * n,
    "farhi": lambda n: 2 * n - 2,
    "sim_circ_15": lambda n: 2 * n,
    "cross_mesh": lambda n: 4 * n + n * (n - 1),
    "rot_ring": lambda n: 3 * n,
}


def build(name: str, n: int) -> Program:
    if name not in BUILDERS:
        raise ValueError(f"unknown ansatz {name!r}; have {sorted(BUILDERS)}")
    return BUILDERS[name](n)
