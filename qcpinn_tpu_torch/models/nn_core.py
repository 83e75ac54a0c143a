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


def rbf_init(
    in_dim: int,
    count: int,
    centers: Optional[torch.Tensor] = None,
    width: float = 8.0,
    lo: float = 0.0,
    hi: float = 1.0,
    out_dim: int = 1,
    generator: Optional[torch.Generator] = None,
) -> nn.ParameterDict:
    """Anisotropic Gaussian-RBF head parameters {c, w, v, a}.

    Each unit contributes ``a_k * exp(-sum_d (w_kd (x_d - c_kd))^2
    - sum_d v_kd x_d)`` — an exponential of a learnable quadratic, so a
    single unit can represent separable Gaussian pulses exactly (including
    an exp(-lambda*t) decay factor via the linear term ``v``). ``centers``
    overrides the uniform draw (see :func:`rbf_centers_from_samples`)."""
    if centers is None:
        centers = lo + (hi - lo) * torch.rand((count, in_dim), generator=generator)
    w = width * (1.0 + 0.25 * torch.randn((count, in_dim), generator=generator))
    return nn.ParameterDict({
        "c": nn.Parameter(torch.as_tensor(centers, dtype=torch.float32).detach().cpu().clone()),
        "w": nn.Parameter(w),
        "v": nn.Parameter(torch.zeros((count, in_dim))),
        "a": nn.Parameter(torch.full((count, out_dim), 0.1)),
    })


def rbf_centers_from_samples(
    generator: torch.Generator, X: torch.Tensor, weights: torch.Tensor,
    count: int, jitter: float = 0.02,
) -> torch.Tensor:
    """Draw RBF centers from sample points with probability proportional to
    ``|weights|`` (e.g. |forcing| at collocation points), with replacement,
    plus a Gaussian jitter. Draws on the generator's device."""
    w = torch.abs(weights).reshape(-1)
    idx = torch.multinomial(w / torch.sum(w), count, replacement=True,
                            generator=generator)
    noise = torch.randn((count, X.shape[1]), generator=generator, device=X.device)
    return X[idx] + jitter * noise


def rbf_apply(params, x: torch.Tensor) -> torch.Tensor:
    """[B, in] -> [B, out] additive head value (out from a's trailing dim;
    a 1-D ``a`` yields [B, 1])."""
    d = x[:, None, :] - params["c"][None, :, :]
    q = torch.sum((params["w"][None, :, :] * d) ** 2, dim=-1) + torch.sum(
        params["v"][None, :, :] * x[:, None, :], dim=-1
    )
    # the learnable linear term v.x is unbounded below; clamp the exponent
    # so a few bad optimizer steps on v cannot overflow exp(-q) to inf
    out = torch.exp(-torch.clamp(q, min=-30.0)) @ params["a"]
    return out[:, None] if out.ndim == 1 else out
