"""Forward-mode PDE residual operators (port of
qcpinn_tpu/physics/operators_fwd.py): the five PDEs of ``cli train`` and
the Czochralski melt's ``cz_residuals_fwd``.

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


def wave_operator_fwd(apply: ModelFn, X: torch.Tensor, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_tt - c^2 u_xx, c = 2; ``X = [t, x]``."""
    c = 2.0

    def f(Xp):
        return apply(Xp)[:, 0]

    u, _, u_tt = _d2(f, X, 0)
    _, _, u_xx = _d2(f, X, 1)
    return u[:, None], (u_tt - c * c * u_xx)[:, None]


def klein_gordon_operator_fwd(apply: ModelFn, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_tt + alpha u_xx + beta u + gamma u^k, alpha=-1, beta=0, gamma=1,
    k=3; ``X = [t, x]``."""
    alpha, beta, gamma, k = -1.0, 0.0, 1.0, 3

    def f(Xp):
        return apply(Xp)[:, 0]

    u, _, u_tt = _d2(f, X, 0)
    _, _, u_xx = _d2(f, X, 1)
    residual = u_tt + alpha * u_xx + beta * u + gamma * u**k
    return u[:, None], residual[:, None]


def helmholtz_operator_fwd(apply: ModelFn, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_x1x1 + u_x2x2 + lambda u, lambda = 1; ``X = [x1, x2]``."""
    lam = 1.0

    def f(Xp):
        return apply(Xp)[:, 0]

    u, _, u_11 = _d2(f, X, 0)
    _, _, u_22 = _d2(f, X, 1)
    return u[:, None], (u_11 + u_22 + lam * u)[:, None]


def navier_stokes_2d_operator_fwd(
    apply: ModelFn, X: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[continuity, f_u, f_v] with mu = 0.00345, rho = 1056; ``X = [t, x,
    y]``, outputs ``[u, v, p]``: one jvp per (coordinate, order) over the
    full 3-output model."""
    mu = 0.00345
    rho = 1056.0

    uvp, d_t = _d1(apply, X, 0)
    _, d_x, d2_x = _d2(apply, X, 1)
    _, d_y, d2_y = _d2(apply, X, 2)

    u, v = uvp[:, 0], uvp[:, 1]
    u_t, v_t = d_t[:, 0], d_t[:, 1]
    u_x, v_x, p_x = d_x[:, 0], d_x[:, 1], d_x[:, 2]
    u_y, v_y, p_y = d_y[:, 0], d_y[:, 1], d_y[:, 2]
    u_xx, v_xx = d2_x[:, 0], d2_x[:, 1]
    u_yy, v_yy = d2_y[:, 0], d2_y[:, 1]

    continuity = u_x + v_y
    f_u = u_t + (u * u_x + v * u_y) + p_x / rho - mu * (u_xx + u_yy)
    f_v = v_t + (u * v_x + v * v_y) + p_y / rho - mu * (v_xx + v_yy)
    return continuity[:, None], f_u[:, None], f_v[:, None]


def cz_residuals_fwd(
    apply: ModelFn,
    x: torch.Tensor,
    pressure_coeff: float,
    re: float,
    pr: float,
    gr: float,
):
    """Forward-mode version of ``physics.cylindrical.cz_residuals``: one
    jvp-over-jvp of the full 5-output model along r, one along z."""
    from .cylindrical import cz_terms

    pred, d_r, d2_r = _d2(apply, x, 0)
    _, d_z, d2_z = _d2(apply, x, 1)
    return cz_terms(pred, d_r, d_z, d2_r, d2_z, x, pressure_coeff, re, pr, gr)
