"""PDE residual operators by reverse-mode autograd through the full model
(port of qcpinn_tpu/physics/operators.py; nn/pde.py in the reference).

First derivatives are ``torch.autograd.grad(u, X, ones, create_graph=True)``
(torch's sum-gradient semantics: d(sum u)/dX, right for batch-coupled
models like the Hopfield baseline); second derivatives are the same call
on a column of that gradient, d(sum_j g_jc)/dX_ic, which is the JAX
package's ``jax.linearize`` column because the Hessian of sum(u) is
symmetric. The operators build the graph whatever the caller's grad mode
(an evaluation under ``torch.no_grad`` still needs it), and the loss
backpropagates through it. A derivative the model does not depend on is
zero, as JAX gives it.

Every operator takes ``apply: [B, d] -> [B, m]`` (the model with its
parameters) and the coordinate block ``X``; constants are the reference's
(cited per function).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

ModelFn = Callable[[torch.Tensor], torch.Tensor]


def _sum_grad(y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """d(sum y)/dX, ``[B, d]``, with its graph kept."""
    if not y.requires_grad:
        return torch.zeros_like(X)
    (g,) = torch.autograd.grad(y, X, torch.ones_like(y), create_graph=True,
                               allow_unused=True)
    return torch.zeros_like(X) if g is None else g


def _hess_cols(y: torch.Tensor, X: torch.Tensor, cols: Sequence[int]):
    """First-derivative block g[B, d] of sum(y) and, for each c in cols,
    d^2(sum y)/dX_c^2 per batch row ([B])."""
    g = _sum_grad(y, X)
    return g, [_sum_grad(g[:, c], X)[:, c] for c in cols]


def _leaf(X: torch.Tensor) -> torch.Tensor:
    return X.detach().requires_grad_(True)


@torch.enable_grad()
def diffusion_operator(
    apply: ModelFn,
    X: torch.Tensor,
    sigma_t: float = 1.0,
    sigma_x: float = 1.0,
    sigma_y: float = 1.0,
    D: float = 0.01,
    v_x: float = 1.0,
    v_y: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convection-diffusion residual u_t + v.grad(u) - D lap(u)
    (nn/pde.py:53-72). ``X = [t, x, y]`` columns; returns (u, residual) as
    ``[B, 1]``."""
    X = _leaf(X)
    u = apply(X)[:, 0]
    g, (u_xx, u_yy) = _hess_cols(u, X, (1, 2))
    u_t = g[:, 0] / sigma_t
    u_x = g[:, 1] / sigma_x
    u_y = g[:, 2] / sigma_y
    u_xx = u_xx / (sigma_x * sigma_x)
    u_yy = u_yy / (sigma_y * sigma_y)
    residual = u_t + v_x * u_x + v_y * u_y - D * (u_xx + u_yy)
    return u[:, None], residual[:, None]


@torch.enable_grad()
def wave_operator(
    apply: ModelFn, X: torch.Tensor, sigma_t: float = 1.0, sigma_x: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_tt - c^2 u_xx with c = 2 (nn/pde.py:42-52). ``X = [t, x]``."""
    c = 2.0
    X = _leaf(X)
    u = apply(X)[:, 0]
    _, (u_tt, u_xx) = _hess_cols(u, X, (0, 1))
    return u[:, None], (u_tt - c * c * u_xx)[:, None]


@torch.enable_grad()
def klein_gordon_operator(apply: ModelFn, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_tt + alpha u_xx + beta u + gamma u^k, alpha=-1, beta=0, gamma=1,
    k=3 (nn/pde.py:28-41). ``X = [t, x]``."""
    alpha, beta, gamma, k = -1.0, 0.0, 1.0, 3
    X = _leaf(X)
    u = apply(X)[:, 0]
    _, (u_tt, u_xx) = _hess_cols(u, X, (0, 1))
    residual = u_tt + alpha * u_xx + beta * u + gamma * u**k
    return u[:, None], residual[:, None]


@torch.enable_grad()
def helmholtz_operator(apply: ModelFn, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_x1x1 + u_x2x2 + lambda u with lambda = 1 (nn/pde.py:73-95).
    ``X = [x1, x2]``."""
    lam = 1.0
    X = _leaf(X)
    u = apply(X)[:, 0]
    _, (u_11, u_22) = _hess_cols(u, X, (0, 1))
    return u[:, None], (u_11 + u_22 + lam * u)[:, None]


@torch.enable_grad()
def navier_stokes_2d_operator(
    apply: ModelFn, X: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Incompressible 2D Navier-Stokes residuals [continuity, f_u, f_v]
    with mu = 0.00345, rho = 1056 (nn/pde.py:2-27). ``X = [t, x, y]``;
    model outputs ``[u, v, p]``. One forward; each output's sum-gradient
    on its own column."""
    mu = 0.00345
    rho = 1056.0
    X = _leaf(X)
    out = apply(X)
    u, v, p = out[:, 0], out[:, 1], out[:, 2]
    gu, (u_xx, u_yy) = _hess_cols(u, X, (1, 2))
    gv, (v_xx, v_yy) = _hess_cols(v, X, (1, 2))
    gp = _sum_grad(p, X)

    u_t, u_x, u_y = gu[:, 0], gu[:, 1], gu[:, 2]
    v_t, v_x, v_y = gv[:, 0], gv[:, 1], gv[:, 2]
    p_x, p_y = gp[:, 1], gp[:, 2]

    continuity = u_x + v_y
    f_u = u_t + (u * u_x + v * u_y) + p_x / rho - mu * (u_xx + u_yy)
    f_v = v_t + (u * v_x + v * v_y) + p_y / rho - mu * (v_xx + v_yy)
    return continuity[:, None], f_u[:, None], f_v[:, None]
