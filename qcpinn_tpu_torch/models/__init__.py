"""Models of the PyTorch port."""

from .dv_fourier import DVFourierSolver
from .dv_solver import DVSolver

__all__ = ["DVFourierSolver", "DVSolver"]
