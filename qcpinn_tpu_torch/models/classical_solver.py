"""Classical baseline: the modern-Hopfield (batch self-association) solver
(port of qcpinn_tpu/models/classical_solver.py), as an ``nn.Module``.

  pre:      Linear(in, hidden) -> Tanh
  hopfield: softmax(beta * Q K^T) V over the batch (self-association),
            Q, K, V from Linear(hidden, hidden) without bias
  residual: pre + hopfield
  post:     Tanh -> Linear(hidden, out)

The B x B attention couples the batch, so the PDE residual of this model
must be the reverse-mode operator (``physics/operators.py``: torch's
sum-gradient semantics) and its loss terms must not be concatenated into
one call (``batch_coupled``; ``train/loop.py`` reads it). The two B x B
products are plain ``torch.matmul`` in full f32 (TF32 is off package-wide),
as the JAX package computes them outside any kernel. ``model(x)`` is the
JAX package's ``model.apply(params, x)``.

Under a data-parallel mesh each rank holds its rows of the batch; JAX's
GSPMD keeps the attention global, and so does the port: inside
``batch_sharded`` the keys and values are gathered over the data axis
(``collectives.gather_rows``), whose backward sums each rank's cotangents
into the owner's rows, so the sum-gradient residual keeps its cross-rank
terms. Without the context the softmax would silently turn local.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from .. import resolve_device
from ..config import QCPINNConfig
from . import nn_core as nc

HOPFIELD_KEYS = ("w_q", "w_k", "w_v")


def hopfield_init(input_dim: int, hidden_dim: int, generator=None) -> nn.ModuleDict:
    """The three bias-free projections, Xavier-normal."""
    return nn.ModuleDict({
        k: nc.linear_init(input_dim, hidden_dim, generator, bias=False)
        for k in HOPFIELD_KEYS
    })


def hopfield_apply(layers: nn.ModuleDict, x: torch.Tensor, beta: float = 1.0,
                   gather=None) -> torch.Tensor:
    """``gather(rows) -> rows of the whole batch`` when ``x`` is this rank's
    part of a batch split over a mesh: the keys and values then span the
    whole batch, the queries stay this rank's."""
    q = nc.linear_apply(layers["w_q"], x)
    k = nc.linear_apply(layers["w_k"], x)
    v = nc.linear_apply(layers["w_v"], x)
    if gather is not None:
        k, v = gather(torch.cat([k, v], dim=1)).split([k.shape[1], v.shape[1]], dim=1)
    weights = torch.softmax(torch.matmul(q, k.T) * beta, dim=-1)
    return torch.matmul(weights, v)


class ClassicalSolver(nn.Module):
    # the B x B Hopfield attention self-associates over the batch, so loss
    # terms must NOT be concatenated into one call (train/loop.py)
    batch_coupled = True

    def __init__(self, config: QCPINNConfig, beta: float = 1.0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.beta = beta
        in_dim, hidden, out_dim = config.classic_network
        self.in_dim, self.hidden, self.out_dim = in_dim, hidden, out_dim
        generator = torch.Generator().manual_seed(config.seed)
        self.pre = nc.linear_init(in_dim, hidden, generator)
        self.hopfield = hopfield_init(hidden, hidden, generator)
        self.post = nc.linear_init(hidden, out_dim, generator)
        self.to(device)
        self._gather = None

    @contextlib.contextmanager
    def batch_sharded(self, mesh, rows: int, axis: str = "data"):
        """Within: the model's inputs are this rank's part of a ``rows``-row
        batch split over ``mesh``'s ``axis`` (``mesh.shard_batch``), and the
        attention spans the whole batch."""
        from ..parallel.collectives import gather_rows

        ax = mesh.axis(axis)
        prev, self._gather = self._gather, lambda t: gather_rows(t, ax, rows)
        try:
            yield self
        finally:
            self._gather = prev

    @property
    def device(self) -> torch.device:
        return self.pre.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = torch.tanh(nc.linear_apply(self.pre, x))
        hop = hopfield_apply(self.hopfield, pre, self.beta, self._gather)
        # residual connection (nn/ClassicalSolver.py:70-71)
        return nc.linear_apply(self.post, torch.tanh(pre + hop))
