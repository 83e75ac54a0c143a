"""Models of the PyTorch port."""

from .classical_solver import ClassicalSolver
from .crystal import CrystalPINN
from .cv_solver import CVSolver
from .czochralski import CzQuantumLayer, Hybrid16QPINN
from .dv_fourier import DVFourierSolver
from .dv_solver import DVSolver

__all__ = ["ClassicalSolver", "CrystalPINN", "CVSolver", "CzQuantumLayer",
           "DVFourierSolver", "DVSolver", "Hybrid16QPINN"]
