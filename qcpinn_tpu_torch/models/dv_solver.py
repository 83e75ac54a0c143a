"""DV hybrid PDE solver (port of qcpinn_tpu/models/dv_solver.py), as an
``nn.Module``: classical encoder -> quantum circuit -> decoder.

  pre:  Linear(in, hidden) Tanh Linear(n_qubits)   (raw output = the angles)
  q:    DVCircuit (any ansatz, ``config.encoding``), <Z_w> readout: exact,
        through the config's noise channel, or shot-sampled
  post: Linear(n_qubits, hidden) Tanh Linear(out)

Unlike :class:`DVFourierSolver`, the angles are the encoder's raw output
(no pi * tanh) and there is no skip path, so :meth:`encode` returns the
angles alone. ``encode``/``head``/``qblock``/``use_fused`` have
``DVFourierSolver``'s signatures, so the tangent-stream residual
(``physics/streams.py``) and ``make_train_step`` take either model.
``model(x)`` is the JAX package's ``model.apply(params, x)``;
``hw_apply_fn(shots)`` its hardware-fidelity forward (parameter-shift
gradients, ``train/hardware_grad.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import QCPINNConfig
from ..ops import DVCircuit, NoiseModel, make_fused_backend
from . import nn_core as nc


class DVSolver(nn.Module):
    def __init__(self, config: QCPINNConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.n = config.num_qubits
        in_dim, hidden, out_dim = config.classic_network
        self.in_dim, self.hidden, self.out_dim = in_dim, hidden, out_dim
        self.circuit = DVCircuit(
            num_qubits=self.n,
            num_quantum_layers=config.num_quantum_layers,
            q_ansatz=config.q_ansatz,
            encoding=config.encoding,
            seed=config.seed,
        )
        generator = torch.Generator().manual_seed(config.seed)
        self.pre = nc.mlp_init((in_dim, hidden, self.n), generator)
        self.q = nn.Parameter(self.circuit.init_params(generator, device="cpu"))
        self.post = nc.mlp_init((self.n, hidden, out_dim), generator)
        self.noise = None
        if config.noise_depolarizing or config.noise_readout or config.noise_per_gate:
            self.noise = NoiseModel(config.noise_depolarizing, config.noise_readout,
                                    config.noise_per_gate).bind(self.circuit)
        self.to(device)
        self._fused = None

    @property
    def device(self) -> torch.device:
        return self.q.device

    def use_fused(self, backend: str = "auto") -> "DVSolver":
        """Evolution engine on the model's device (ops/backends.py). The JAX
        ``use_pallas`` catches any error and keeps the gate-by-gate path;
        here an engine that cannot run the circuit raises, because a silent
        switch of engine would change what a run measures and which kernels
        it exercises without saying so."""
        self._fused = make_fused_backend(self.circuit, backend, device=self.device)
        return self

    def use_sharded(self, mesh, amp_axis: str = "amp", data_axis: str = "data",
                    backend: str = "gate") -> "DVSolver":
        """Route the quantum block through an amplitude-sharded engine: the
        2^n state split over the mesh's ``amp_axis``, this rank's rows of
        the batch over ``data_axis``. Differentiable to any order, so it
        composes with the nested-AD PDE operators inside the train step.
        ``backend='gate'`` is the per-gate engine (parallel/sharded_sv.py,
        cross-shard gates by partner exchanges); ``'block'`` the block-fused
        engine over a sharded high block (parallel/sharded_block.py,
        all-to-alls around the high-block products). Both cover the whole
        apply contract, shots and noise included."""
        if backend == "block":
            from ..parallel.sharded_block import ShardedBlockCircuit

            self._fused = ShardedBlockCircuit(self.circuit, mesh, amp_axis, data_axis)
        elif backend == "gate":
            from ..parallel.sharded_sv import ShardedCircuit

            self._fused = ShardedCircuit(self.circuit, mesh, amp_axis, data_axis)
        else:
            raise ValueError(f"unknown sharded backend {backend!r}")
        return self

    @property
    def qblock(self):
        return self._fused if self._fused is not None else self.circuit

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, in] -> [B, n]: the circuit angles (no extra columns)."""
        return nc.mlp_apply(self.pre, x)

    def head(self, feat: torch.Tensor) -> torch.Tensor:
        return nc.mlp_apply(self.post, feat)

    def hw_apply_fn(self, shots: Optional[int]):
        """``apply(x, key) -> [B, out]`` whose quantum block takes the
        parameter-shift estimator (train/hardware_grad.py): shot-sampled
        readouts (``key`` a ``torch.Generator``; unused when ``shots`` is
        None), gradients from shifted evaluations (the reference's
        diff_method="parameter-shift", nn/DVQuantumLayer.py:140) into the
        quantum weights and through the circuit's inputs into the encoder.
        The config's noise channel rides along, as in ``forward``."""
        from ..train.hardware_grad import make_hw_apply

        hw = make_hw_apply(self.circuit, shots, noise=self.noise)

        def apply(x: torch.Tensor, key: Optional[torch.Generator] = None) -> torch.Tensor:
            return self.head(hw(self.q, self.encode(x), key))

        return apply

    def forward(
        self,
        x: torch.Tensor,
        *,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        detach_quantum: bool = False,
    ) -> torch.Tensor:
        z = self.qblock.apply(self.q, self.encode(x), shots=shots, key=key,
                              noise=self.noise)
        if detach_quantum:
            # two-phase head tuning: the decoder trains on a frozen readout
            z = z.detach()
        return self.head(z)
