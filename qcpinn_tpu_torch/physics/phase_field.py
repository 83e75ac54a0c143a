"""Phase-field crystal-growth physics (port of
qcpinn_tpu/physics/phase_field.py; hybrid_qpinn_2dcrystal_ibmtest.py).

Model outputs (u, v, p, c, phi) on (x, y); physics:

- anisotropic surface energy eps(theta) = EPS0 (1 + DELTA cos(m theta)),
  theta = atan2(phi_y, phi_x + 1e-8)                      (:196-198)
- chemical potential mu = -eps^2 lap(phi) + phi(phi^2 - 1) - 2 LAMBDA_C c phi
                                                          (:200-206)
- Stefan residual mu - LAMBDA_T c |grad phi|              (:208-210)
- crystal-growth loss = <mu^2> + <stefan^2> + <|grad phi|^2>  (:241-265)
- adaptive interface sampling: oversample candidates with |phi| < 0.1
  (:216-235), ranked so the shapes are static.

Derivatives keep the reference's sum-gradient semantics: the reference
differentiates the SUM OF ALL FIVE OUTPUTS at once (:245-248), so phi_x
here is really d(u+v+p+c+phi)/dx; reproduced exactly (a documented quirk).
They are reverse-mode autograd (``physics/operators.py``'s helpers: the
Hessian columns of a sum-gradient are the JAX package's ``jax.linearize``
columns, the Hessian being symmetric); the graph is built whatever the
caller's grad mode, so an SPSA evaluation under ``no_grad`` gets its loss.
"""

from __future__ import annotations

from typing import Callable

import torch

from .operators import _hess_cols, _leaf

EPS0 = 0.01
DELTA_ANISO = 0.05
ANISO_M = 4
LAMBDA_C = 1.0
LAMBDA_T = 1.0


def anisotropic_epsilon(phi_x: torch.Tensor, phi_y: torch.Tensor) -> torch.Tensor:
    theta = torch.atan2(phi_y, phi_x + 1e-8)
    return EPS0 * (1.0 + DELTA_ANISO * torch.cos(ANISO_M * theta))


def phase_field_mu(phi, phi_x, phi_y, lap_phi, c) -> torch.Tensor:
    eps = anisotropic_epsilon(phi_x, phi_y)
    return -(eps**2) * lap_phi + phi * (phi**2 - 1.0) - 2.0 * LAMBDA_C * c * phi


def stefan_residual(mu, phi_x, phi_y, c) -> torch.Tensor:
    grad_norm = torch.sqrt(phi_x**2 + phi_y**2 + 1e-8)
    return mu - LAMBDA_T * c * grad_norm


@torch.enable_grad()
def crystal_growth_loss(apply: Callable[[torch.Tensor], torch.Tensor],
                        x: torch.Tensor) -> torch.Tensor:
    """The reference's loss (:241-265), with its exact derivative semantics:
    gradients of the SUM of all outputs with respect to x."""
    X = _leaf(x)
    out = apply(X)
    c, phi = out[:, 3], out[:, 4]
    g, (h_xx, h_yy) = _hess_cols(out.sum(dim=1), X, (0, 1))
    phi_x, phi_y = g[:, 0], g[:, 1]
    mu = phase_field_mu(phi, phi_x, phi_y, h_xx + h_yy, c)
    stefan = stefan_residual(mu, phi_x, phi_y, c)
    return torch.mean(mu**2) + torch.mean(stefan**2) + torch.mean(phi_x**2 + phi_y**2)


def draw_candidates(generator: torch.Generator, n_bulk: int, n_cand: int, device=None):
    """(bulk points [n_bulk, 2], interface candidates [n_cand, 2]), uniform
    on the unit square, from ``generator``: every random draw of the
    sampling."""
    x_bulk = torch.rand((n_bulk, 2), generator=generator, device=device)
    x_cand = torch.rand((n_cand, 2), generator=generator, device=device)
    return x_bulk, x_cand


@torch.no_grad()
def select_interface(apply: Callable[[torch.Tensor], torch.Tensor], x_bulk: torch.Tensor,
                     x_cand: torch.Tensor, n_interface: int,
                     threshold: float = 0.1) -> torch.Tensor:
    """The bulk points and the ``n_interface`` candidates nearest the
    interface: candidates are scored |phi| below ``threshold`` and |phi| +
    1e3 above it, and a stable sort keeps the first ``n_interface`` (ties
    in the candidates' order, as ``jnp.argsort``)."""
    phi = apply(x_cand)[:, 4]
    score = torch.where(torch.abs(phi) < threshold, torch.abs(phi), torch.abs(phi) + 1e3)
    idx = torch.argsort(score, stable=True)[:n_interface]
    return torch.cat([x_bulk, x_cand[idx]], dim=0)


def adaptive_interface_sampling(
    apply: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    n_bulk: int = 32,
    n_interface: int = 64,
    threshold: float = 0.1,
    candidate_factor: int = 5,
    device=None,
) -> torch.Tensor:
    """Oversample near the solid-liquid interface |phi| < threshold
    (:216-235): ``n_bulk`` uniform points and the ``n_interface`` best of
    ``candidate_factor * n_interface`` candidates (static shapes: the same
    coverage as the reference's mask-then-top-up)."""
    x_bulk, x_cand = draw_candidates(generator, n_bulk, candidate_factor * n_interface, device)
    return select_interface(apply, x_bulk, x_cand, n_interface, threshold)
