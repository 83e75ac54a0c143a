"""Evolution-engine dispatch (port of
qcpinn_tpu/ops/pallas_loop.py::make_fused_backend).

- ``block``: :class:`BlockFusedCircuit`, plain torch, any-order AD.
- ``block_kernel``: :class:`BlockKernelCircuit`, the raw segment chain in
  the hand-written CUDA block-chain kernels (n <= 12 on the card);
  reverse-mode AD only; needs a decomposition with no boundary-straddling
  segment (cross_mesh qualifies, ring-closure ansatzes do not).
- ``loop``: :class:`LoopFusedCircuit`, the gate table in the hand-written
  CUDA gate-loop kernels (1 <= n <= 16 on the card); any ansatz;
  reverse-mode AD only.
- ``unrolled``: :class:`FusedCircuit`, the unrolled micro-program in the
  hand-written CUDA kernels of ``csrc/unrolled_sv.cu`` (1 <= n <= 12 on the
  card); any ansatz; reverse-mode AD only.

``auto`` is a stated rule, not a fallback: on CUDA it picks ``unrolled`` at
7 <= n <= 9 (as the compiled JAX default does), ``block_kernel`` at
10 <= n <= 12 when ``supports()`` holds, ``loop`` at 13 <= n <= 16 (the
16-qubit step took 151 ms of card time against 234 ms on ``block``, whose
block-chain kernels stop at 12 qubits), else ``block``; on the CPU it
picks ``block``. At n >= 10 this differs from the JAX default, which picks
the plain XLA block engine: that choice was a TPU measurement and says
nothing about the H100. Nothing here catches an error and carries on.
"""

from __future__ import annotations

from .. import resolve_device
from . import loop_kernel, sv_kernel
from .block_fused import BlockFusedCircuit
from .block_kernel import MAX_QUBITS, BlockKernelCircuit, supports
from .circuit import DVCircuit
from .loop_kernel import LoopFusedCircuit
from .sv_kernel import FusedCircuit

BACKENDS = ("auto", "block", "block_kernel", "loop", "unrolled")


def make_fused_backend(circuit: DVCircuit, backend: str = "auto", device=None):
    """Pick the evolution engine for a circuit on ``device`` (default: the
    card; raises without CUDA)."""
    device = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "auto":
        on_card = device.type == "cuda"
        if on_card and 7 <= circuit.n <= 9:
            backend = "unrolled"
        elif on_card and 10 <= circuit.n <= MAX_QUBITS and supports(circuit):
            backend = "block_kernel"
        elif on_card and MAX_QUBITS < circuit.n <= loop_kernel.MAX_QUBITS:
            backend = "loop"
        else:
            backend = "block"
    if backend == "unrolled":
        if device.type == "cuda" and circuit.n > sv_kernel.MAX_QUBITS:
            raise ValueError(
                f"unrolled runs n <= {sv_kernel.MAX_QUBITS} on the card; "
                f"got n = {circuit.n}"
            )
        return FusedCircuit(circuit)
    if backend == "block":
        return BlockFusedCircuit(circuit)
    if backend == "loop":
        if device.type == "cuda" and circuit.n > loop_kernel.MAX_QUBITS:
            raise ValueError(
                f"loop runs n <= {loop_kernel.MAX_QUBITS} on the card; "
                f"got n = {circuit.n}"
            )
        return LoopFusedCircuit(circuit)
    if device.type == "cuda" and circuit.n > MAX_QUBITS:
        raise ValueError(
            f"block_kernel runs n <= {MAX_QUBITS} on the card; got n = {circuit.n}"
        )
    return BlockKernelCircuit(circuit)
