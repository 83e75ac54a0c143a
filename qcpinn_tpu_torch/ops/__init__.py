"""Quantum-circuit engine of the PyTorch port."""

from . import ansatz, gates, measure, program, statevector
from .block_fused import BlockFusedCircuit
from .block_kernel import BlockKernelCircuit
from .backends import make_fused_backend
from .circuit import DVCircuit
from .loop_kernel import LoopFusedCircuit
from .measure import NoiseModel
from .sv_kernel import FusedCircuit

__all__ = [
    "ansatz",
    "gates",
    "measure",
    "program",
    "statevector",
    "BlockFusedCircuit",
    "BlockKernelCircuit",
    "DVCircuit",
    "FusedCircuit",
    "LoopFusedCircuit",
    "NoiseModel",
    "make_fused_backend",
]
