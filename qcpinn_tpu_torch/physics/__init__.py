"""PDE residuals of the PyTorch port."""

from .cylindrical import cz_residuals
from .jet import cz_residuals_jet
from .operators import (
    diffusion_operator,
    helmholtz_operator,
    klein_gordon_operator,
    navier_stokes_2d_operator,
    wave_operator,
)
from .operators_fwd import (
    cz_residuals_fwd,
    diffusion_operator_fwd,
    helmholtz_operator_fwd,
    klein_gordon_operator_fwd,
    navier_stokes_2d_operator_fwd,
    wave_operator_fwd,
)

__all__ = [
    "diffusion_operator",
    "helmholtz_operator",
    "klein_gordon_operator",
    "navier_stokes_2d_operator",
    "wave_operator",
    "diffusion_operator_fwd",
    "helmholtz_operator_fwd",
    "klein_gordon_operator_fwd",
    "navier_stokes_2d_operator_fwd",
    "wave_operator_fwd",
    "cz_residuals",
    "cz_residuals_fwd",
    "cz_residuals_jet",
    "get_operator",
]


def get_operator(problem: str, mode: str = "fwd"):
    """Select an operator. mode='fwd' (nested jvps: point-decoupled models
    only) or 'rev' (torch's sum-gradient semantics, required for
    batch-coupled models like the Hopfield baseline)."""
    table = {
        "diffusion": (diffusion_operator, diffusion_operator_fwd),
        "wave": (wave_operator, wave_operator_fwd),
        "klein_gordon": (klein_gordon_operator, klein_gordon_operator_fwd),
        "helmholtz": (helmholtz_operator, helmholtz_operator_fwd),
        "navier_stokes": (navier_stokes_2d_operator, navier_stokes_2d_operator_fwd),
    }
    rev_op, fwd_op = table[problem]
    return fwd_op if mode == "fwd" else rev_op
