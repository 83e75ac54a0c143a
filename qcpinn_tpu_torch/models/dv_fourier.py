"""DV solver with a Fourier-feature encoder (port of
qcpinn_tpu/models/dv_fourier.py), as an ``nn.Module``.

  pre:  [x, FF(x)] -> Linear(h) Tanh Linear(h) Tanh Linear(n_qubits)
  q:    DVCircuit (any ansatz), angle encoding, angles = pi * tanh(.)
  post: [z, skip] -> Linear(h) Tanh Linear(h) Tanh Linear(out)

with a classical skip (tanh of a Linear(h -> skip_dim) on the trunk) around
the quantum block. ``model(x)`` is the JAX package's
``model.apply(params, x)``; the parameters live in the module.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..config import QCPINNConfig
from ..ops import DVCircuit, make_fused_backend
from . import nn_core as nc


class DVFourierSolver(nn.Module):
    def __init__(
        self,
        config: QCPINNConfig,
        mapping_size: int = 32,
        ff_scale: float = 4.0,
        skip_dim: int = 32,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.n = config.num_qubits
        in_dim, hidden, out_dim = config.classic_network
        self.in_dim, self.hidden, self.out_dim = in_dim, hidden, out_dim
        self.mapping = mapping_size
        self.skip_dim = skip_dim
        self.circuit = DVCircuit(
            num_qubits=self.n,
            num_quantum_layers=config.num_quantum_layers,
            q_ansatz=config.q_ansatz,
            encoding="angle",
            seed=config.seed,
        )
        generator = torch.Generator().manual_seed(config.seed)
        ff_gen = torch.Generator().manual_seed(config.seed)
        # stop_gradient'd in the JAX package: a buffer, not a parameter
        self.register_buffer(
            "B", nc.fourier_features_init(in_dim, mapping_size, ff_scale, ff_gen)
        )
        feat = in_dim + 2 * mapping_size
        self.pre = nc.mlp_init((feat, hidden, hidden, self.n), generator)
        self.skip = nc.mlp_init((hidden, skip_dim), generator)
        self.q = nn.Parameter(self.circuit.init_params(generator, device="cpu"))
        self.post = nc.mlp_init(
            (self.n + skip_dim, hidden, hidden, out_dim), generator
        )
        self.to(device)
        self._fused = None

    @property
    def device(self) -> torch.device:
        return self.q.device

    def use_fused(self, backend: str = "auto") -> "DVFourierSolver":
        """Evolution engine on the model's device (ops/backends.py). Raises
        if the backend cannot run the circuit: nothing falls back."""
        self._fused = make_fused_backend(self.circuit, backend, device=self.device)
        return self

    @property
    def qblock(self):
        return self._fused if self._fused is not None else self.circuit

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, in] -> [B, n + skip_dim]: the circuit angles, then the skip
        features."""
        h = torch.cat([x, nc.fourier_features_apply(self.B, x)], dim=-1)
        for layer in self.pre[:-1]:
            h = torch.tanh(nc.linear_apply(layer, h))
        angles = math.pi * torch.tanh(nc.linear_apply(self.pre[-1], h))
        skip = torch.tanh(nc.linear_apply(self.skip[0], h))
        return torch.cat([angles, skip], dim=-1)

    def head(self, feat: torch.Tensor) -> torch.Tensor:
        return nc.mlp_apply(self.post, feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.encode(x)
        z = self.qblock.apply(self.q, enc[:, : self.n])
        return self.head(torch.cat([z, enc[:, self.n :]], dim=-1))
