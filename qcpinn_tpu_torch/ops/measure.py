"""Measurement (port of qcpinn_tpu/ops/measure.py): exact expectations,
shot sampling and noise channels, as modes of the same engine.

- exact: ``<Z_w>`` from the statevector (differentiable, the training path).
- shots: per-wire binomial draws of the measured bit; each single-qubit
  estimator has the hardware law Var[Z_hat] = (1 - <Z>^2) / S
  (extras/cg_qpinn.tex:86-89). Cross-qubit correlations are not modelled:
  only per-qubit ``<Z_i>`` are consumed downstream. The draws come from an
  explicit ``torch.Generator`` (the port's PRNG key) and carry no gradient.
- depolarizing/readout noise, a FakeSherbrooke-style stand-in
  (cg-hqpinn/CG_HQPINN_IBMtest_16q_effective.py:183-196) applied to the Z
  expectations: ``depolarizing`` shrinks <Z> by (1-p) per qubit, ``readout``
  flips the measured bit with prob q (a factor 1-2q), and ``per_gate``
  damps <Z_w> by (1-p)^{c_w}, c_w the gate-wire touches on wire w over the
  whole circuit (encoding, every ansatz layer, epilogue), so the error
  grows with depth. Bind the counts with ``noise.bind(circuit)`` (every
  engine does so at its measurement site).

The per-wire factors are a device constant, built once per channel, width
and device outside any ``torch.func`` transform, so a CUDA graph captures
a multiply by a fixed tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import statevector as sv
from .gates import untransformed


def gate_counts_per_wire(circuit) -> tuple:
    """Per-wire gate-touch counts over the full circuit (encoding + every
    ansatz layer + epilogue): the static exponent of the depth-aware
    depolarizing channel. A circuit with a bespoke structure exposes its own
    ``gate_counts_per_wire()``; a DVCircuit is counted from ``program_raw``
    (before diagonal fusion, so every CRZ of a cross_mesh counts) and
    ``epilogue``. The encoding counts one touch per wire."""
    own = getattr(circuit, "gate_counts_per_wire", None)
    if callable(own):
        return tuple(own())
    counts = np.ones(circuit.n, dtype=np.int64)
    for op in circuit.program_raw:
        for w in op.wires:
            counts[w] += circuit.layers
    for op in circuit.epilogue:
        for w in op.wires:
            counts[w] += 1
    return tuple(int(c) for c in counts)


@functools.lru_cache(maxsize=64)
def _wire_scales(depolarizing, readout, per_gate, gate_counts, n, device):
    base = (1.0 - depolarizing) * (1.0 - 2.0 * readout)
    scales = np.full((n,), base, dtype=np.float32)
    if per_gate:
        counts = np.asarray(gate_counts[:n], dtype=np.float32)
        scales = scales * np.float32(1.0 - per_gate) ** counts
    with untransformed():
        return torch.as_tensor(scales.astype(np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Per-qubit depolarizing + readout error applied to Z expectations.
    ``per_gate`` adds the depth-aware channel (module docstring): it needs
    per-wire gate counts, bound from a circuit by ``bind(circuit)``."""

    depolarizing: float = 0.0
    readout: float = 0.0
    per_gate: float = 0.0
    gate_counts: Optional[tuple] = None

    def bind(self, circuit) -> "NoiseModel":
        """Attach the circuit's static per-wire gate counts (the model
        itself when the depth-aware channel is off or already bound)."""
        if self.per_gate == 0.0 or self.gate_counts is not None:
            return self
        return dataclasses.replace(self, gate_counts=gate_counts_per_wire(circuit))

    def wire_scales(self, n: int, device=None) -> torch.Tensor:
        """[n] damping factors of the per-wire <Z_w>, on ``device``."""
        if self.per_gate and self.gate_counts is None:
            raise ValueError(
                "per_gate noise needs per-wire gate counts; call "
                "noise.bind(circuit) at the measurement site"
            )
        return _wire_scales(float(self.depolarizing), float(self.readout),
                            float(self.per_gate), self.gate_counts, n,
                            torch.device(device or "cpu"))

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.wire_scales(z.shape[-1], z.device)


def exact_z(state: torch.Tensor, n: int, noise: Optional[NoiseModel] = None):
    z = sv.z_expvals(state, n)
    if noise is not None:
        z = noise.apply(z)
    return z


def exact_global_z(
    state: torch.Tensor, n: int, noise: Optional[NoiseModel] = None
) -> torch.Tensor:
    """``<Z⊗...⊗Z>`` per sample, ``[B]``. Each tensor factor of the parity
    observable is damped independently, so the channel scales it by the
    product of the per-wire factors."""
    z = sv.global_z_expval(state, n)
    if noise is not None:
        z = z * torch.prod(noise.wire_scales(n, z.device))
    return z


def _binomial(p: torch.Tensor, shots: int, key: torch.Generator) -> torch.Tensor:
    return torch.binomial(torch.full_like(p, float(shots)), p, generator=key)


def sampled_global_z(
    state: torch.Tensor,
    n: int,
    shots: int,
    key: torch.Generator,
    noise: Optional[NoiseModel] = None,
) -> torch.Tensor:
    """Shot-sampled global parity: Binomial(shots, p_even) with
    p_even = (1 + <Z..Z>)/2, estimator 2*k/shots - 1 (Var = (1 -
    <Z..Z>^2)/S), without gradient."""
    z = exact_global_z(state, n, noise).detach()
    p_even = torch.clamp((1.0 + z) / 2.0, 0.0, 1.0)
    return 2.0 * _binomial(p_even, shots, key) / float(shots) - 1.0


def sampled_z(
    state: torch.Tensor,
    n: int,
    shots: int,
    key: torch.Generator,
    noise: Optional[NoiseModel] = None,
) -> torch.Tensor:
    """Shot-sampled ``<Z_w>``: Binomial(shots, p1_w) per wire, returned as
    1 - 2*k/shots. Not differentiable by construction: the hardware
    gradient paths (parameter-shift, SPSA) evaluate it again at shifted
    parameters, as the reference does on IBM hardware
    (nn/DVQuantumLayer.py:140)."""
    return sample_z_from_expectations(exact_z(state, n, noise), shots, key)


def sample_z_from_expectations(
    z: torch.Tensor, shots: int, key: torch.Generator
) -> torch.Tensor:
    """The binomial shot estimator on computed ``<Z>`` values, any shape
    (one draw an element from ``key``)."""
    p1 = torch.clamp((1.0 - z.detach()) / 2.0, 0.0, 1.0)
    return 1.0 - 2.0 * _binomial(p1, shots, key) / float(shots)


def read_z(
    z: torch.Tensor,
    *,
    shots: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    noise: Optional[NoiseModel] = None,
) -> torch.Tensor:
    """The readout modes on exact ``<Z_w>`` ``[B, n]``: the noise channel,
    then the shot sampler when ``shots`` is set. Every engine's ``apply``
    ends here."""
    if noise is not None:
        z = noise.apply(z)
    if shots is None:
        return z
    return sample_z_from_expectations(z, shots, key)


def check_key(shots: Optional[int], key) -> None:
    if shots is not None and key is None:
        raise ValueError("shots mode needs a PRNG key")
