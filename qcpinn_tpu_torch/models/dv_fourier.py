"""DV solver with a Fourier-feature encoder (port of
qcpinn_tpu/models/dv_fourier.py), as an ``nn.Module``.

  pre:  [x, FF(x)] -> Linear(h) Tanh Linear(h) Tanh Linear(n_qubits)
  q:    DVCircuit (any ansatz), angle encoding, angles = pi * tanh(.)
  post: [z, skip] -> Linear(h) Tanh Linear(h) Tanh Linear(out)

with a classical skip (tanh of a Linear(h -> skip_dim) on the trunk) around
the quantum block, and with ``rbf_count > 0`` an additive Gaussian-RBF head
on the output (``nn_core.rbf_apply`` of the raw input). ``model(x)`` is the
JAX package's ``model.apply(params, x)``; the parameters live in the
module.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..config import QCPINNConfig
from ..ops import DVCircuit, make_fused_backend
from . import nn_core as nc


class ZeroQ:
    """The quantum block zeroed (the north-star run's stage 1): z = 0, the
    circuit never runs."""

    def __init__(self, n: int):
        self.n = n

    def apply(self, qp, x):
        return torch.zeros((x.shape[0], self.n), dtype=x.dtype, device=x.device)


class DVFourierSolver(nn.Module):
    def __init__(
        self,
        config: QCPINNConfig,
        mapping_size: int = 32,
        ff_scale: float = 4.0,
        skip_dim: int = 32,
        rbf_count: int = 0,
        rbf_width: float = 8.0,
        rbf_centers=None,
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
        self.rbf_count = rbf_count
        self.rbf_width = rbf_width
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
        # additive localized head at the output (a direct gradient path)
        self.rbf = (
            nc.rbf_init(in_dim, rbf_count, centers=rbf_centers, width=rbf_width,
                        out_dim=out_dim, generator=generator)
            if rbf_count > 0 else None
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

    def use_sharded(self, mesh, amp_axis: str = "amp",
                    data_axis: str = "data") -> "DVFourierSolver":
        """Amplitude-sharded quantum block (see DVSolver.use_sharded)."""
        from ..parallel.sharded_sv import ShardedCircuit

        self._fused = ShardedCircuit(self.circuit, mesh, amp_axis, data_axis)
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
        out = self.head(torch.cat([z, enc[:, self.n :]], dim=-1))
        if self.rbf is not None:
            out = out + nc.rbf_apply(self.rbf, x)
        return out

    def jet(self, x: torch.Tensor, cols2: range):
        """``forward`` with its first derivative along each input column
        and its second along each column of ``cols2``, in one pass (the
        jets of ``nn_core``): (out [B, out], tangents [in + len(cols2), B,
        out]). Only with the quantum block zeroed (stage 1): z = 0 carries
        no tangent, so the angle layer never reaches the output and is
        skipped, and the first post layer sees only its skip columns.
        Raises unless the quantum block is ``ZeroQ``."""
        if not isinstance(self.qblock, ZeroQ):
            raise ValueError("DVFourierSolver.jet takes the quantum block "
                             "zeroed (ZeroQ, stage 1)")
        ff, t_ff = nc.fourier_features_jet(self.B, x, cols2)
        h = torch.cat([x, ff], dim=-1)
        th = torch.cat([nc.input_jet(x, cols2), t_ff], dim=-1)
        for layer in self.pre[:-1]:
            h, th = nc.tanh_jet(*nc.linear_jet(layer, h, th), cols2)
        skip, t_skip = nc.tanh_jet(*nc.linear_jet(self.skip[0], h, th), cols2)
        post = self.post
        h, th = nc.tanh_jet(*nc.linear_jet(post[0], skip, t_skip,
                                           post[0].weight[:, self.n:]), cols2)
        for layer in post[1:-1]:
            h, th = nc.tanh_jet(*nc.linear_jet(layer, h, th), cols2)
        out, t_out = nc.linear_jet(post[-1], h, th)
        if self.rbf is not None:
            r, t_r = nc.rbf_jet(self.rbf, x, cols2)
            out, t_out = out + r, t_out + t_r
        return out, t_out
