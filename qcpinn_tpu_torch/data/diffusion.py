"""Convection-diffusion analytic solutions, forcing and samplers (port of
qcpinn_tpu/data/diffusion.py).

1. Gaussian pulse (data/diffusion_dataset.py:20-38):
   u = exp(-100((x-0.5)^2 + (y-0.5)^2)) * exp(-t), with closed-form partials
   and forcing r = u_t + v.grad(u) - D lap(u). Both the reference's second
   partials (constant -400, kept for parity) and the true ones (-200) are
   here; see :func:`u_xx`.
2. Separable sine (train_hybrid_qpinn.py:116-131):
   u = sin(pi x) sin(pi y) exp(-2 pi^2 D t), which solves the pure
   diffusion equation u_t = D lap(u) with zero Dirichlet boundaries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

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


def u_sine(txy: torch.Tensor, D: float = DEFAULT_D) -> torch.Tensor:
    t = txy[:, 0:1]
    x = txy[:, 1:2]
    y = txy[:, 2:3]
    pi = math.pi
    return torch.sin(pi * x) * torch.sin(pi * y) * torch.exp(-2.0 * pi**2 * D * t)


def zero_target(txy: torch.Tensor) -> torch.Tensor:
    return torch.zeros((txy.shape[0], 1), dtype=txy.dtype, device=txy.device)


def _rows_on(sampler, device: torch.device, *arrays) -> Tuple[torch.Tensor, ...]:
    """``arrays`` as [1, dim] float32 tensors on ``device``, built once per
    sampler and device: a draw then copies nothing from the host, so it can
    be captured in a CUDA graph. The cache lives beside the dataclass
    fields (a frozen dataclass still has a ``__dict__``)."""
    cache = sampler.__dict__.setdefault("_on_device", {})
    if device not in cache:
        cache[device] = tuple(
            torch.as_tensor(np.asarray(a, dtype=np.float32).reshape(1, -1),
                            device=device) for a in arrays)
    return cache[device]


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
        lo, hi = _rows_on(self, dev, self.coords[0], self.coords[1])
        rand = torch.rand((n, self.dim), generator=generator, device=dev)
        x = lo + (hi - lo) * rand
        return x, self.func(x)


@dataclasses.dataclass(frozen=True)
class MixtureSampler:
    """Uniform/focused mixture sampler for sharply-localized solutions.

    The first ``frac * n`` rows of each draw come from a Gaussian around
    ``focus``, clipped to the box, in every dim whose ``sigma > 0``; the
    rest, and the dims with ``sigma <= 0``, are uniform. Targets are exact
    either way; only the training distribution changes."""

    coords: np.ndarray  # [2, dim]
    func: Callable[[torch.Tensor], torch.Tensor]
    focus: np.ndarray  # [dim]
    sigma: np.ndarray  # [dim]; <= 0 -> uniform in that dim
    frac: float = 0.5
    name: Optional[str] = None

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    def sample(self, generator: torch.Generator, n: int):
        """Draws on the generator's device: the uniform block, then the
        Gaussian block."""
        dev = generator.device
        lo, hi, mu, sd = _rows_on(self, dev, self.coords[0], self.coords[1],
                                  self.focus, self.sigma)
        x_uni = lo + (hi - lo) * torch.rand((n, self.dim), generator=generator,
                                            device=dev)
        noise = torch.randn((n, self.dim), generator=generator, device=dev)
        x_foc = torch.minimum(torch.maximum(mu + sd * noise, lo), hi)
        rows = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
        use_foc = (rows < self.frac * n) & (sd > 0.0)
        x = torch.where(use_foc, x_foc, x_uni)
        return x, self.func(x)


def pulse_residual_sampler(
    frac: float = 0.5, sigma: float = 0.12, func: Optional[Callable] = None
) -> MixtureSampler:
    """Residual sampler focused on the Gaussian pulse at (x, y) = (.5, .5),
    uniform in t. Defaults to the consistent forcing :func:`r_true`."""
    if func is None:
        func = r_true
    return MixtureSampler(
        _box([[0, 0, 0], [1, 1, 1]]),
        func,
        focus=np.array([0.5, 0.5, 0.5], dtype=np.float32),
        sigma=np.array([-1.0, sigma, sigma], dtype=np.float32),
        frac=frac,
        name="Forcing (pulse-focused)",
    )


def _box(rows) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32)


def gaussian_pulse_samplers() -> dict:
    """Canonical IC/BC/domain boxes (data/diffusion_dataset.py:39-57):
    IC at t=0; Dirichlet boundaries at x=0 and x=1; forcing over the cube.
    The forcing is the reference's ``r`` (its defect kept, see
    :func:`u_xx`)."""
    return {
        "ics": Sampler(_box([[0, 0, 0], [0, 1, 1]]), u, "Initial Condition"),
        "bc1": Sampler(_box([[0, 0, 0], [1, 0, 1]]), u, "Dirichlet BC1"),
        "bc2": Sampler(_box([[0, 1, 0], [1, 1, 1]]), u, "Dirichlet BC2"),
        "res": Sampler(_box([[0, 0, 0], [1, 1, 1]]), r, "Forcing"),
    }


def sine_samplers(D: float = DEFAULT_D) -> dict:
    """train_hybrid_qpinn.py:159-200: IC from the analytic solution, four
    zero-Dirichlet boundaries, zero-residual domain sampler."""
    def ic_fn(X):
        return u_sine(X, D)

    return {
        "ics": Sampler(_box([[0, 0, 0], [0, 1, 1]]), ic_fn, "Initial Condition"),
        "bc1": Sampler(_box([[0, 0, 0], [1, 0, 1]]), zero_target, "x=0"),
        "bc2": Sampler(_box([[0, 1, 0], [1, 1, 1]]), zero_target, "x=1"),
        "bc3": Sampler(_box([[0, 0, 0], [1, 1, 0]]), zero_target, "y=0"),
        "bc4": Sampler(_box([[0, 0, 1], [1, 1, 1]]), zero_target, "y=1"),
        "res": Sampler(_box([[0, 0, 0], [1, 1, 1]]), zero_target, "Residual"),
    }
