"""The DV quantum layer (port of qcpinn_tpu/ops/circuit.py).

A compile-time circuit build plus a pure ``apply(params, x) -> [B, n]``:
RX angle (or amplitude) encoding, ``num_quantum_layers`` x ansatz, the
fixed seeded Haar 4x4 blocks on wires [0,1], [2,3] when n >= 4 and a seed is set,
a Hadamard on the last wire, and ``<Z_w>`` for every wire
(nn/DVQuantumLayer.py:176-214). Gradients flow by ordinary autograd.
The circuit holds no tensors: it computes on its inputs' device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import ansatz as ansatz_lib
from . import diag_fusion, gates, measure
from . import program as prog
from . import statevector as sv


class DVCircuit:
    """Static circuit description + pure apply. Args mirror the
    reference's args dict: num_qubits, num_quantum_layers, q_ansatz,
    encoding, seed."""

    def __init__(
        self,
        num_qubits: int,
        num_quantum_layers: int = 1,
        q_ansatz: str = "cascade",
        encoding: str = "angle",
        seed: Optional[int] = None,
        fuse: bool = True,
    ):
        if encoding not in ("angle", "angle_pi", "amplitude"):
            raise ValueError(
                f"unknown encoding {encoding!r}; have angle, angle_pi, amplitude"
            )
        self.n = num_qubits
        self.layers = num_quantum_layers
        self.ansatz = q_ansatz
        self.encoding = encoding
        # 'angle_pi' is RX(pi * x): same encoder, inputs scaled by pi
        self.input_scale = math.pi if encoding == "angle_pi" else 1.0
        self.seed = seed
        self.program_raw = ansatz_lib.build(q_ansatz, num_qubits)
        self.params_per_layer = prog.num_params(self.program_raw)
        if self.params_per_layer != ansatz_lib.PARAM_COUNTS[q_ansatz](num_qubits):
            raise ValueError(f"{q_ansatz}: parameter count mismatch")
        # commuting RZ/PS/CZ/CRZ runs become single phase ops
        self.program = (
            diag_fusion.fuse_diagonals(self.program_raw, num_qubits)
            if fuse
            else self.program_raw
        )
        epilogue = []
        if num_qubits >= 4 and seed is not None:
            u1, u2 = gates.haar_2q_pair(seed)
            epilogue.append(prog.Op("u2q", (0, 1), const=u1))
            epilogue.append(prog.Op("u2q", (2, 3), const=u2))
        if num_qubits > 0:
            epilogue.append(prog.Op("h", (num_qubits - 1,)))
        self.epilogue = tuple(epilogue)

    # -- parameters ---------------------------------------------------------

    def init_params(
        self, generator: Optional[torch.Generator] = None, device=None
    ) -> torch.Tensor:
        """Xavier-normal over the (layers, P) view, as
        ``torch.nn.init.xavier_normal_`` in nn/DVQuantumLayer.py:216-244."""
        device = resolve_device(device)
        shape = (self.layers, self.params_per_layer)
        std = math.sqrt(2.0 / (shape[0] + shape[1]))
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (std * w).to(device)

    @property
    def num_params(self) -> int:
        return self.layers * self.params_per_layer

    # -- forward ------------------------------------------------------------

    def prepare(self, x: torch.Tensor) -> torch.Tensor:
        """Encode inputs ``[B, F]`` into the initial state ``[B, 2^n]``."""
        if self.encoding == "amplitude":
            return sv.encode_amplitude(x, self.n)
        state = sv.zero_state(x.shape[0], self.n, device=x.device)
        return sv.encode_angle(state, self.n, x * self.input_scale)

    def evolve(self, params: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """All ansatz layers + epilogue on a prepared state."""
        params = params.reshape(self.layers, self.params_per_layer)
        for layer in range(self.layers):
            state = prog.apply_program(state, self.n, self.program, params[layer])
        return prog.apply_program(state, self.n, self.epilogue, params[0, :0])

    def state(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.evolve(params, self.prepare(x))

    def apply(
        self,
        params: torch.Tensor,
        x: torch.Tensor,
        *,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        noise: Optional[measure.NoiseModel] = None,
    ) -> torch.Tensor:
        """``[B, F] -> [B, n]`` per-wire Z expectations: exact, through
        ``noise``, and sampled with ``shots`` draws from the generator
        ``key`` when ``shots`` is set."""
        measure.check_key(shots, key)
        if noise is not None:
            noise = noise.bind(self)  # depth-aware gate counts
        z = sv.z_expvals(self.state(params, x), self.n)
        return measure.read_z(z, shots=shots, key=key, noise=noise)

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)

    def dense_unitary(self, params) -> np.ndarray:
        """Test oracle: the full circuit unitary (ansatz layers + epilogue),
        excluding the input encoding."""
        params = np.asarray(params).reshape(self.layers, self.params_per_layer)
        total = np.eye(1 << self.n, dtype=np.complex128)
        for layer in range(self.layers):
            total = prog.dense_unitary(self.n, self.program_raw, params[layer]) @ total
        return prog.dense_unitary(self.n, self.epilogue, np.zeros(0)) @ total
