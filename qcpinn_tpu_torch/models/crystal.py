"""Hybrid phase-field crystal-growth PINN (port of
qcpinn_tpu/models/crystal.py; the reference's ``HybridCrystalPINN``,
hybrid_qpinn_2dcrystal_ibmtest.py:89-191), as an ``nn.Module``:

  backbone:  Linear(2, 64) -> Tanh -> Linear(64, 32) -> Tanh      (:68-82)
  pre_q:     Linear(32, n_qubits)                                 (:180)
  quantum:   RX(x_q) input encoding; per layer {RX, RY, RZ per
             qubit} + CNOT chain (q, q+1); readout = the single
             global <Z⊗...⊗Z> observable                          (:89-113,
             :133-135)
  post:      Linear(1, 32) -> Tanh -> Linear(32, 5)               (:181-185)

Outputs per point (x, y): (u, v, p, c, phi) — velocities, pressure, solute
concentration, phase field (:170-175). The quantum weights are the
parameter ``q`` (the JAX tree's top-level ``"q"``), so the SPSA/Adam split
(``train/spsa.py::split_params``) draws the boundary the reference draws
when it hands ``[model.q.weights]`` to its SPSAOptimizer (:316-320). The
circuit runs gate by gate on the statevector engine (``ops/program.py``):
no kernel of the package is on this path, as none is in JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops import measure
from ..ops import program as prog
from ..ops import statevector as sv
from . import nn_core as nc


def _crystal_program(n_qubits: int, n_layers: int) -> prog.Program:
    """The reference's hardware-efficient ansatz (:89-113): per layer, RX,
    RY, RZ on every qubit (one parameter each, qubit-major then gate-major
    like the reference's nested loop) followed by a CNOT chain."""
    ops = []
    p = 0
    for _ in range(n_layers):
        for q in range(n_qubits):
            for kind in ("rx", "ry", "rz"):
                ops.append(prog.Op(kind, (q,), (p,)))
                p += 1
        for q in range(n_qubits - 1):
            ops.append(prog.Op("cnot", (q, q + 1)))
    return tuple(ops)


class CrystalPINN(nn.Module):
    """5-output hybrid crystal-growth model around a global-Z quantum
    scalar. The initial weights are drawn from a generator seeded with
    ``seed``: Xavier-normal layers, ``q`` = 0.01 N(0, 1) (:128-130)."""

    quantum_param_keys = ("q",)

    def __init__(self, n_qubits: int = 4, n_layers: int = 3, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.n = n_qubits
        self.layers = n_layers
        self.program = _crystal_program(n_qubits, n_layers)
        self.num_q_params = prog.num_params(self.program)
        if self.num_q_params != 3 * n_qubits * n_layers:
            raise AssertionError("the ansatz has 3 parameters a qubit and layer")
        generator = torch.Generator().manual_seed(seed)
        self.backbone = nc.mlp_init((2, 64, 32), generator)
        self.pre_q = nc.linear_init(32, self.n, generator)
        self.q = nn.Parameter(0.01 * torch.randn(self.num_q_params, generator=generator))
        self.post = nc.mlp_init((1, 32, 5), generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def gate_counts_per_wire(self):
        """Per-wire gate touches for the depth-aware noise channel: the
        encoding + the already-unrolled program's touches."""
        counts = [1] * self.n
        for op in self.program:
            for w in op.wires:
                counts[w] += 1
        return tuple(counts)

    def quantum_scalar(
        self,
        q_params: torch.Tensor,
        q_in: torch.Tensor,
        *,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        noise: Optional[measure.NoiseModel] = None,
    ) -> torch.Tensor:
        """``[B, n] -> [B]`` global-parity expectation of the ansatz."""
        if noise is not None:
            noise = noise.bind(self)
        state = sv.zero_state(q_in.shape[0], self.n, device=q_in.device)
        state = sv.encode_angle(state, self.n, q_in)
        state = prog.apply_program(state, self.n, self.program, q_params)
        if shots is None:
            return measure.exact_global_z(state, self.n, noise)
        measure.check_key(shots, key)
        return measure.sampled_global_z(state, self.n, shots, key, noise)

    def forward(
        self,
        x: torch.Tensor,
        *,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        noise: Optional[measure.NoiseModel] = None,
    ) -> torch.Tensor:
        """``[B, 2] -> [B, 5]`` (u, v, p, c, phi)."""
        z = nc.mlp_apply(self.backbone, x, final_activation=True)
        q_in = nc.linear_apply(self.pre_q, z)
        q_out = self.quantum_scalar(self.q, q_in, shots=shots, key=key, noise=noise)
        return nc.mlp_apply(self.post, q_out[:, None])
