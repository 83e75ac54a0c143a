"""Models of the PyTorch port."""

from .classical_solver import ClassicalSolver
from .dv_fourier import DVFourierSolver
from .dv_solver import DVSolver

__all__ = ["ClassicalSolver", "DVFourierSolver", "DVSolver"]
