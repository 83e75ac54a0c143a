"""Evolution-engine dispatch (port of
qcpinn_tpu/ops/pallas_loop.py::make_fused_backend).

- ``block``: :class:`BlockFusedCircuit`, plain torch, any-order AD.
- ``block_kernel``: :class:`BlockKernelCircuit`, the raw segment chain in
  the hand-written CUDA block-chain kernels (n <= 12 on the card);
  reverse-mode AD only; needs a decomposition with no boundary-straddling
  segment (cross_mesh qualifies, ring-closure ansatzes do not).
- ``loop`` / ``unrolled``: not yet ported.

``auto`` is a stated rule, not a fallback: on CUDA at 10 <= n <= 12 it
picks ``block_kernel`` when ``supports()`` holds, else ``block``; on the CPU
it picks ``block``. This differs from the JAX default, which picks the
plain XLA block engine at n >= 10: that choice was a TPU measurement and
says nothing about the H100. Nothing here catches an error and carries on.
"""

from __future__ import annotations

from .. import resolve_device
from .block_fused import BlockFusedCircuit
from .block_kernel import MAX_QUBITS, BlockKernelCircuit, supports
from .circuit import DVCircuit

BACKENDS = ("auto", "block", "block_kernel", "loop", "unrolled")


def make_fused_backend(circuit: DVCircuit, backend: str = "auto", device=None):
    """Pick the evolution engine for a circuit on ``device`` (default: the
    card; raises without CUDA)."""
    device = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "auto":
        on_card = device.type == "cuda" and 10 <= circuit.n <= MAX_QUBITS
        backend = "block_kernel" if on_card and supports(circuit) else "block"
    if backend in ("loop", "unrolled"):
        raise NotImplementedError(f"backend {backend!r}: not yet ported")
    if backend == "block":
        return BlockFusedCircuit(circuit)
    if device.type == "cuda" and circuit.n > MAX_QUBITS:
        raise ValueError(
            f"block_kernel runs n <= {MAX_QUBITS} on the card; got n = {circuit.n}"
        )
    return BlockKernelCircuit(circuit)
