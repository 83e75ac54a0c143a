"""Quantum-circuit engine of the PyTorch port."""

from .block_fused import BlockFusedCircuit
from .block_kernel import BlockKernelCircuit
from .backends import make_fused_backend
from .circuit import DVCircuit
from .loop_kernel import LoopFusedCircuit
from .sv_kernel import FusedCircuit

__all__ = [
    "BlockFusedCircuit",
    "BlockKernelCircuit",
    "DVCircuit",
    "FusedCircuit",
    "LoopFusedCircuit",
    "make_fused_backend",
]
