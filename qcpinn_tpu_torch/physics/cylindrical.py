"""Axisymmetric cylindrical Navier-Stokes and energy residuals of the
Czochralski melt, by reverse-mode autograd (port of
qcpinn_tpu/physics/cylindrical.py; CG_HQPINN_IBMtest_16qubits.py:322-397).

Model: (r, z) -> (u_r, u_z, u_theta, p_hat, theta). Nondimensional steady
equations with Re/Pr/Gr and the dataset pressure_coeff:

  continuity: du_r/dr + u_r/r + du_z/dz
  mom_r:  u_r u_r,r + u_z u_r,z - u_t^2/r + pc p,r
          - (1/Re)(u_r,rr + u_r,r/r - u_r/r^2 + u_r,zz)
  mom_z:  u_r u_z,r + u_z u_z,z + pc p,z
          - (1/Re)(u_z,rr + u_z,r/r + u_z,zz) - (Gr/Re^2) theta
  swirl:  u_r u_t,r + u_z u_t,z + u_r u_t / r
          - (1/Re)(u_t,rr + u_t,r/r - u_t/r^2 + u_t,zz)
  energy: u_r T,r + u_z T,z - (1/(Pr Re))(T,rr + T,r/r + T,zz)

One forward; each field's sum-gradient and its two Hessian diagonal columns
by ``physics/operators.py``'s helpers (``physics_mode="rev"``, and the plain
check of the forward-mode ``operators_fwd.cz_residuals_fwd``). The model is
point-decoupled, so the sum-gradient is each point's own gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .operators import _hess_cols, _leaf, _sum_grad


def cz_terms(pred, d_r, d_z, d2_r, d2_z, x, pressure_coeff, re, pr, gr):
    """The five mean-square residual terms from the fields ``pred [B, 5]``,
    their first derivatives along r and z and the second along each
    (``[B, 5]`` each; p's second derivatives are not used). Returns (total,
    terms)."""
    u_r, u_z, u_t, theta = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 4]
    ur_r, uz_r, ut_r, p_r, T_r = (d_r[:, i] for i in range(5))
    ur_z, uz_z, ut_z, p_z, T_z = (d_z[:, i] for i in range(5))
    ur_rr, uz_rr, ut_rr, T_rr = d2_r[:, 0], d2_r[:, 1], d2_r[:, 2], d2_r[:, 4]
    ur_zz, uz_zz, ut_zz, T_zz = d2_z[:, 0], d2_z[:, 1], d2_z[:, 2], d2_z[:, 4]

    r = torch.clamp(x[:, 0], min=1e-4)
    pc = pressure_coeff
    continuity = ur_r + u_r / r + uz_z
    mom_r = (
        u_r * ur_r + u_z * ur_z - (u_t**2) / r + pc * p_r
        - (1.0 / re) * (ur_rr + ur_r / r - u_r / (r**2) + ur_zz)
    )
    mom_z = (
        u_r * uz_r + u_z * uz_z + pc * p_z
        - (1.0 / re) * (uz_rr + uz_r / r + uz_zz)
        - (gr / (re**2)) * theta
    )
    swirl = (
        u_r * ut_r + u_z * ut_z + (u_r * u_t) / r
        - (1.0 / re) * (ut_rr + ut_r / r - u_t / (r**2) + ut_zz)
    )
    energy = u_r * T_r + u_z * T_z - (1.0 / (pr * re)) * (T_rr + T_r / r + T_zz)

    terms = {
        "cont": torch.mean(continuity**2),
        "mom_r": torch.mean(mom_r**2),
        "mom_z": torch.mean(mom_z**2),
        "swirl": torch.mean(swirl**2),
        "energy": torch.mean(energy**2),
    }
    return sum(terms.values()), terms


@torch.enable_grad()
def cz_residuals(
    apply: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    pressure_coeff: float,
    re: float,
    pr: float,
    gr: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, per-term mean-square dict), as physics_loss
    (CG...16qubits.py:322-397)."""
    X = _leaf(x)
    pred = apply(X)
    firsts, seconds = [], []
    for k in range(5):
        if k == 3:  # p: first derivatives only
            firsts.append(_sum_grad(pred[:, 3], X))
            seconds.append((torch.zeros_like(X[:, 0]),) * 2)
        else:
            g, cols = _hess_cols(pred[:, k], X, (0, 1))
            firsts.append(g)
            seconds.append(cols)
    d_r = torch.stack([g[:, 0] for g in firsts], dim=1)
    d_z = torch.stack([g[:, 1] for g in firsts], dim=1)
    d2_r = torch.stack([s[0] for s in seconds], dim=1)
    d2_z = torch.stack([s[1] for s in seconds], dim=1)
    return cz_terms(pred, d_r, d_z, d2_r, d2_z, x, pressure_coeff, re, pr, gr)
