"""Convection-diffusion analytic solution, forcing and samplers (port of
qcpinn_tpu/data/diffusion.py).

Gaussian pulse (data/diffusion_dataset.py:20-38):
u = exp(-100((x-0.5)^2 + (y-0.5)^2)) * exp(-t), with closed-form partials
and forcing r = u_t + v.grad(u) - D lap(u). Both the reference's second
partials (constant -400, kept for parity) and the true ones (-200) are
here; see :func:`u_xx`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

DEFAULT_D = 0.01
DEFAULT_V_X = 1.0
DEFAULT_V_Y = 1.0


def u(txy: torch.Tensor) -> torch.Tensor:
    t = txy[:, 0:1]
    x = txy[:, 1:2]
    y = txy[:, 2:3]
    return torch.exp(-100.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2)) * torch.exp(-t)


def u_t(txy):
    return -u(txy)


def u_x(txy):
    return -200.0 * (txy[:, 1:2] - 0.5) * u(txy)


def u_y(txy):
    return -200.0 * (txy[:, 2:3] - 0.5) * u(txy)


def u_xx(txy):
    """The reference formula (data/diffusion_dataset.py:31-32), kept for
    parity. Its constant is wrong: the true second partial has -200, not
    -400, so the reference forcing ``r`` exceeds the true residual of its
    own u by ``+400 D u``. Use :func:`u_xx_true` / :func:`r_true` for the
    correct physics."""
    return (40000.0 * (txy[:, 1:2] - 0.5) ** 2 - 400.0) * u(txy)


def u_yy(txy):
    """Reference-parity formula; see :func:`u_xx`."""
    return (40000.0 * (txy[:, 2:3] - 0.5) ** 2 - 400.0) * u(txy)


def u_xx_true(txy):
    return (40000.0 * (txy[:, 1:2] - 0.5) ** 2 - 200.0) * u(txy)


def u_yy_true(txy):
    return (40000.0 * (txy[:, 2:3] - 0.5) ** 2 - 200.0) * u(txy)


def r(txy, D: float = DEFAULT_D, v_x: float = DEFAULT_V_X, v_y: float = DEFAULT_V_Y):
    """Reference-parity forcing (uses the reference's second partials)."""
    return u_t(txy) + v_x * u_x(txy) + v_y * u_y(txy) - D * (u_xx(txy) + u_yy(txy))


def r_true(txy, D: float = DEFAULT_D, v_x: float = DEFAULT_V_X, v_y: float = DEFAULT_V_Y):
    """The actual forcing of the analytic solution."""
    return (
        u_t(txy)
        + v_x * u_x(txy)
        + v_y * u_y(txy)
        - D * (u_xx_true(txy) + u_yy_true(txy))
    )


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Uniform sampler over a hyper-rectangle with a target function.
    ``coords`` is ``[2, dim]``: row 0 the mins, row 1 the maxs."""

    coords: np.ndarray
    func: Callable[[torch.Tensor], torch.Tensor]
    name: Optional[str] = None

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    def sample(self, generator: torch.Generator, n: int):
        """Draws on the generator's device."""
        dev = generator.device
        lo = torch.as_tensor(self.coords[0:1, :], dtype=torch.float32, device=dev)
        hi = torch.as_tensor(self.coords[1:2, :], dtype=torch.float32, device=dev)
        rand = torch.rand((n, self.dim), generator=generator, device=dev)
        x = lo + (hi - lo) * rand
        return x, self.func(x)


def _box(rows) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32)
