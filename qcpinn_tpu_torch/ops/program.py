"""Gate-program IR (port of qcpinn_tpu/ops/program.py).

A circuit is a static tuple of :class:`Op`, built once per (ansatz, n).
Parametrized ops carry indices (``pidx``) into a flat per-layer parameter
vector, which keeps the executor independent of any particular ansatz.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import gates, statevector as sv

PARAM_1Q = {"rx", "ry", "rz", "ps"}
PARAM_1Q3 = {"rot"}  # 3 angles: Rot(phi, theta, omega)
PARAM_2Q = {"crx", "cry", "crz"}
FIXED_1Q = {"h", "x", "y", "z"}
FIXED_2Q = {"cnot", "cz", "swap"}

_FIXED_1Q_MATS = {"h": gates.H, "x": gates.X, "y": gates.Y, "z": gates.Z}
_FIXED_2Q_MATS = {"cnot": gates.CNOT, "cz": gates.CZ, "swap": gates.SWAP}
_PARAM_1Q_FNS = {"rx": gates.rx, "ry": gates.ry, "rz": gates.rz, "ps": gates.phase_shift}
_PARAM_2Q_FNS = {"crx": gates.crx, "cry": gates.cry, "crz": gates.crz}
_CTRL_BASE = {"crx": gates.rx, "cry": gates.ry, "crz": gates.rz}


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str
    wires: Tuple[int, ...]
    pidx: Tuple[int, ...] = ()
    # fixed unitary (numpy complex64) for 'u1q' / 'u2q' (e.g. Haar blocks)
    const: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind in PARAM_1Q:
            ok = len(self.wires) == 1 and len(self.pidx) == 1
        elif self.kind in PARAM_1Q3:
            ok = len(self.wires) == 1 and len(self.pidx) == 3
        elif self.kind in PARAM_2Q:
            ok = len(self.wires) == 2 and len(self.pidx) == 1
        elif self.kind in FIXED_1Q:
            ok = len(self.wires) == 1 and not self.pidx
        elif self.kind in FIXED_2Q:
            ok = len(self.wires) == 2 and not self.pidx
        elif self.kind == "u1q":
            ok = len(self.wires) == 1 and self.const is not None
        elif self.kind == "u2q":
            ok = len(self.wires) == 2 and self.const is not None
        else:
            raise ValueError(f"unknown op kind: {self.kind}")
        if not ok:
            raise ValueError(f"malformed op: {self}")


Program = Tuple[Op, ...]


def num_params(program: Program) -> int:
    top = -1
    for op in program:
        for p in op.pidx:
            top = max(top, p)
    return top + 1


def apply_program(
    state: torch.Tensor, n: int, program: Program, params: torch.Tensor
) -> torch.Tensor:
    """Run a gate program. ``params`` is the flat per-layer vector ``[P]``,
    or batched ``[B, P]``."""
    for op in program:
        if not isinstance(op, Op):  # fused DiagRun (see diag_fusion.py)
            state = op.apply(state, params)
            continue
        k = op.kind
        if k in PARAM_1Q:
            theta = params[..., op.pidx[0]]
            state = sv.apply_1q(state, n, op.wires[0], _PARAM_1Q_FNS[k](theta))
        elif k in PARAM_1Q3:
            phi, th, om = (params[..., p] for p in op.pidx)
            state = sv.apply_1q(state, n, op.wires[0], gates.rot(phi, th, om))
        elif k in PARAM_2Q:
            theta = params[..., op.pidx[0]]
            state = sv.apply_ctrl_1q(
                state, n, op.wires[0], op.wires[1], _CTRL_BASE[k](theta)
            )
        elif k in FIXED_1Q:
            state = sv.apply_1q(state, n, op.wires[0], _FIXED_1Q_MATS[k])
        elif k == "cnot":
            state = sv.apply_ctrl_1q(state, n, op.wires[0], op.wires[1], gates.X)
        elif k in FIXED_2Q:
            state = sv.apply_2q(
                state, n, op.wires[0], op.wires[1], _FIXED_2Q_MATS[k]
            )
        elif k == "u1q":
            state = sv.apply_1q(state, n, op.wires[0], op.const)
        elif k == "u2q":
            state = sv.apply_2q(state, n, op.wires[0], op.wires[1], op.const)
        else:  # pragma: no cover - guarded by Op.__post_init__
            raise ValueError(k)
    return state


def dense_unitary(n: int, program: Program, params) -> np.ndarray:
    """Dense ``[2^n, 2^n]`` complex128 matrix of a program, built from
    numpy krons of each gate's full-space matrix (the test oracle)."""
    dim = 1 << n
    total = np.eye(dim, dtype=np.complex128)

    def embed_1q(m: np.ndarray, w: int) -> np.ndarray:
        ops = [np.eye(2, dtype=np.complex128)] * n
        ops[w] = m.astype(np.complex128)
        full = ops[0]
        for o in ops[1:]:
            full = np.kron(full, o)
        return full

    def embed_2q(m4: np.ndarray, wa: int, wb: int) -> np.ndarray:
        full = np.zeros((dim, dim), dtype=np.complex128)
        m4 = m4.astype(np.complex128).reshape(2, 2, 2, 2)
        sa = n - 1 - wa
        sb = n - 1 - wb
        for col in range(dim):
            ba = (col >> sa) & 1
            bb = (col >> sb) & 1
            base = col & ~((1 << sa) | (1 << sb))
            for ka in range(2):
                for kb in range(2):
                    row = base | (ka << sa) | (kb << sb)
                    full[row, col] += m4[ka, kb, ba, bb]
        return full

    def angle(p):
        return torch.tensor(float(params[p]))

    params = np.asarray(params)
    for op in program:
        k = op.kind
        if k in PARAM_1Q:
            g = _PARAM_1Q_FNS[k](angle(op.pidx[0])).numpy()
            total = embed_1q(g, op.wires[0]) @ total
        elif k in PARAM_1Q3:
            g = gates.rot(*(angle(p) for p in op.pidx)).numpy()
            total = embed_1q(g, op.wires[0]) @ total
        elif k in PARAM_2Q:
            g = _PARAM_2Q_FNS[k](angle(op.pidx[0])).numpy()
            total = embed_2q(g, op.wires[0], op.wires[1]) @ total
        elif k in FIXED_1Q:
            total = embed_1q(_FIXED_1Q_MATS[k], op.wires[0]) @ total
        elif k in FIXED_2Q:
            total = embed_2q(_FIXED_2Q_MATS[k], op.wires[0], op.wires[1]) @ total
        elif k == "u1q":
            total = embed_1q(op.const, op.wires[0]) @ total
        elif k == "u2q":
            total = embed_2q(op.const, op.wires[0], op.wires[1]) @ total
    return total
