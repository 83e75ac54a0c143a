"""NN building blocks (port of qcpinn_tpu/models/nn_core.py).

Initialization matches the reference: ``xavier_normal_`` weights and zero
bias (nn/DVPDESolver.py:69-76). Layers are ``nn.Linear`` (weight
``[out, in]``; the JAX package stores ``w[in, out]``, see bridge.py).
Every random draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


def linear_init(
    in_dim: int, out_dim: int, generator: Optional[torch.Generator] = None
) -> nn.Linear:
    """Xavier-normal weight (std = sqrt(2/(in+out))), zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    std = math.sqrt(2.0 / (in_dim + out_dim))
    with torch.no_grad():
        layer.weight.copy_(
            std * torch.randn((out_dim, in_dim), generator=generator)
        )
        layer.bias.zero_()
    return layer


def linear_apply(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight, layer.bias)


def mlp_init(
    dims: Sequence[int], generator: Optional[torch.Generator] = None
) -> nn.ModuleList:
    return nn.ModuleList(
        linear_init(dims[i], dims[i + 1], generator) for i in range(len(dims) - 1)
    )


def mlp_apply(
    layers: nn.ModuleList, x: torch.Tensor, final_activation: bool = False
) -> torch.Tensor:
    """Linear -> Tanh -> ... -> Linear."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = linear_apply(layer, x)
        if i < n - 1 or final_activation:
            x = torch.tanh(x)
    return x


def fourier_features_init(
    in_dim: int, mapping_size: int, scale: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Random Fourier feature matrix B ~ N(0,1) * scale, ``[in, mapping]``:
    a fixed buffer, never trained."""
    return scale * torch.randn((in_dim, mapping_size), generator=generator)


def fourier_features_apply(B: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    proj = 2.0 * math.pi * (x @ B.detach())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
