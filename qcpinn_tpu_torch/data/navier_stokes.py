"""Taylor-Green vortex: the analytic oracle of the Navier-Stokes 2D problem
(port of qcpinn_tpu/data/navier_stokes.py).

With the reference operator's exact form
  f_u = u_t + u u_x + v u_y + p_x / rho - MU (u_xx + u_yy)
(nn/pde.py:17-21), the decaying Taylor-Green field

  u =  -cos(x) sin(y) e^(-2 MU t)
  v =   sin(x) cos(y) e^(-2 MU t)
  p =  -(RHO / 4) (cos(2x) + cos(2y)) e^(-4 MU t)

satisfies continuity, f_u and f_v identically. Domain: (t, x, y) in
[0, 1] x [0, pi] x [0, pi].
"""

from __future__ import annotations

import math

import torch

from .diffusion import Sampler, _box

MU = 0.00345  # nn/pde.py:17 (used as the Laplacian coefficient)
RHO = 1056.0  # nn/pde.py:18

PI = math.pi


def uvp(X: torch.Tensor) -> torch.Tensor:
    """Analytic [u, v, p] for X = [t, x, y] rows -> [B, 3]."""
    t, x, y = X[:, 0], X[:, 1], X[:, 2]
    decay = torch.exp(-2.0 * MU * t)
    u = -torch.cos(x) * torch.sin(y) * decay
    v = torch.sin(x) * torch.cos(y) * decay
    p = -(RHO / 4.0) * (torch.cos(2 * x) + torch.cos(2 * y)) * decay**2
    return torch.stack([u, v, p], dim=-1)


def zero_residuals(X: torch.Tensor) -> torch.Tensor:
    """Residual targets [continuity, f_u, f_v] = 0."""
    return torch.zeros((X.shape[0], 3), dtype=X.dtype, device=X.device)


def taylor_green_samplers() -> dict:
    """res (interior), ic (t=0), and the four spatial walls, every target
    analytic."""
    return {
        "res": Sampler(_box([[0, 0, 0], [1, PI, PI]]), zero_residuals, "res"),
        "ics": Sampler(_box([[0, 0, 0], [0, PI, PI]]), uvp, "ics"),
        "bc1": Sampler(_box([[0, 0, 0], [1, 0, PI]]), uvp, "bc_x0"),
        "bc2": Sampler(_box([[0, PI, 0], [1, PI, PI]]), uvp, "bc_x1"),
        "bc3": Sampler(_box([[0, 0, 0], [1, PI, 0]]), uvp, "bc_y0"),
        "bc4": Sampler(_box([[0, 0, PI], [1, PI, PI]]), uvp, "bc_y1"),
    }


def residual_stack(operator):
    """Adapt a 3-tuple NS operator to the train loop's (u, pred) contract:
    pred = [continuity, f_u, f_v] stacked to [B, 3] (matched against
    ``zero_residuals``)."""

    def op(apply, X):
        continuity, f_u, f_v = operator(apply, X)
        return None, torch.cat([continuity, f_u, f_v], dim=-1)

    return op
