"""The coupled adaptive loss weighting of the SI-gated prototype (port of
qcpinn_tpu/models/si_gated.py:130-143; modified_qpinn_cg.py:142-156), for
the Czochralski pipeline's ``physics_normalize="coupled"``.

A trainable data-noise scale eps_d with the physics scale pinned at
eps_p = eps_d * sqrt(target_ratio):

  total = l_data / (2 eps_d^2) + l_phys / (2 eps_p^2) + log(eps_d eps_p)

``SIChainCircuit`` and the SI head are not yet ported (ROADMAP queue 1,
crystal and SI-gated).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def coupled_weighting_init() -> nn.ParameterDict:
    """{log_eps_data: [1] zeros}, the JAX tree's ``loss_bal`` leaf."""
    return nn.ParameterDict({"log_eps_data": nn.Parameter(torch.zeros(1))})


def coupled_weighting_apply(params, l_data: torch.Tensor, l_phys: torch.Tensor,
                            target_ratio: float = 100.0) -> torch.Tensor:
    eps_data = torch.exp(params["log_eps_data"][0])
    eps_phys = eps_data * math.sqrt(target_ratio)
    return (0.5 / (eps_data**2) * l_data + 0.5 / (eps_phys**2) * l_phys
            + torch.log(eps_data * eps_phys))
