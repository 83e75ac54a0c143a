"""The stage-1 convection-diffusion residual from a second-order forward
jet: the ``(u, residual)`` of ``operators_fwd.diffusion_operator_fwd``
(the twin of ``qcpinn_tpu/physics/operators_fwd.py:49``) at its default
coefficients, for a ``DVFourierSolver`` whose quantum block is zeroed
(``ZeroQ``), in one forward pass.

The nested-jvp operator traces the whole model five times in dual numbers
(one jvp along t, jvp-over-jvp along x and along y), filling in zero
tangents as it goes, and autograd then runs backward through all five.
``DVFourierSolver.jet`` runs the model once and carries the primal and the
d/dt, d/dx, d/dy, d2/dx2, d2/dy2 channels; reverse mode runs through it as
plain autograd. The nested-jvp operator stays as the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.dv_fourier import DVFourierSolver

D = 0.01  # the diffusion coefficient; the velocity is (1, 1)


def diffusion_jet(model: DVFourierSolver, X: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``diffusion_operator_fwd(model, X)`` of the stage-1 model, X = [t, x,
    y]: (u [B, 1], u_t + u_x + u_y - D (u_xx + u_yy) [B, 1]). Raises unless
    the model's quantum block is ``ZeroQ``."""
    if X.shape[1] != 3:
        raise ValueError(f"diffusion_jet takes X = [t, x, y]; got {tuple(X.shape)}")
    u, tu = model.jet(X, range(1, 3))
    u_t, u_x, u_y, u_xx, u_yy = tu[:, :, 0]
    return u[:, :1], (u_t + u_x + u_y - D * (u_xx + u_yy))[:, None]
