"""Forward-mode PDE residual operators (port of
qcpinn_tpu/physics/operators_fwd.py; the diffusion operator only).

For point-decoupled models (every DV solver: each collocation point flows
through the network on its own) the Jacobian across the batch is diagonal,
so forward-over-forward differentiation gives the residual with no reverse
pass: ``torch.func.jvp`` along one input column, nested for second order.
Do not use with a batch-coupled model (the Hopfield baseline).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jvp

ModelFn = Callable[[torch.Tensor], torch.Tensor]


def _col_tangent(X: torch.Tensor, col: int) -> torch.Tensor:
    t = torch.zeros_like(X)
    t[:, col] = 1.0
    return t


def _d1(f: ModelFn, X: torch.Tensor, col: int):
    """(u, du/dcol) via one jvp."""
    return jvp(f, (X,), (_col_tangent(X, col),))


def _d2(f: ModelFn, X: torch.Tensor, col: int):
    """(u, du/dcol, d2u/dcol2) via jvp-over-jvp."""
    tangent = _col_tangent(X, col)

    def g(Xp):
        return jvp(f, (Xp,), (tangent,))

    (u, du), (_, d2u) = jvp(g, (X,), (tangent,))
    return u, du, d2u


def diffusion_operator_fwd(
    apply: ModelFn,
    X: torch.Tensor,
    sigma_t: float = 1.0,
    sigma_x: float = 1.0,
    sigma_y: float = 1.0,
    D: float = 0.01,
    v_x: float = 1.0,
    v_y: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convection-diffusion (u, residual) of ``apply`` at X = [t, x, y]:
    u_t + v.grad(u) - D lap(u), each derivative scaled by its sigma."""

    def f(Xp):
        return apply(Xp)[:, 0]

    _, u_t = _d1(f, X, 0)
    u, u_x, u_xx = _d2(f, X, 1)
    _, u_y, u_yy = _d2(f, X, 2)
    residual = (
        u_t / sigma_t
        + v_x * u_x / sigma_x
        + v_y * u_y / sigma_y
        - D * (u_xx / sigma_x**2 + u_yy / sigma_y**2)
    )
    return u[:, None], residual[:, None]
