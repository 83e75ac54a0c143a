"""CV hybrid PDE solver (port of qcpinn_tpu/models/cv_solver.py;
nn/CVPDESolver.py): the DV solver's classical sandwich around a CV photonic
middle layer, as an ``nn.Module``.

  pre:  Linear(in, hidden) Tanh Linear(m)      (raw output = the encoding)
  cv:   CVLayer (m qumodes, cutoff d, variant 1-3)
  post: Linear(m, hidden) Tanh Linear(out)

``config.num_qubits`` is the number of qumodes, as in the reference. No
kernel of the package is on this path: the JAX package runs it as XLA ops
too. ``model(x)`` is the JAX package's ``model.apply(params, x)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..config import QCPINNConfig
from . import nn_core as nc
from .cv_layer import CVLayer


class CVSolver(nn.Module):
    def __init__(self, config: QCPINNConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.m = config.num_qubits  # the reference reuses num_qubits for qumodes
        in_dim, hidden, out_dim = config.classic_network
        generator = torch.Generator().manual_seed(config.seed)
        self.pre = nc.mlp_init((in_dim, hidden, self.m), generator)
        self.cv = CVLayer(
            num_qumodes=self.m,
            num_layers=config.num_quantum_layers,
            cutoff_dim=config.cutoff_dim,
            variant=config.cv_class,
            readout=getattr(config, "cv_readout", None),
            generator=generator,
        )
        self.post = nc.mlp_init((self.m, hidden, out_dim), generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.cv(nc.mlp_apply(self.pre, x))
        return nc.mlp_apply(self.post, z.to(self.post[0].weight.dtype))
