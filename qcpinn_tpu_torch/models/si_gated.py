"""SI-gated hybrid head, the coupled adaptive loss balancer, and the
EstimatorQNN-chain reuploading circuit (port of
qcpinn_tpu/models/si_gated.py; hybrid_testing/modified_qpinn_cg.py,
si_q_pinn_improved.py).

- SI gating (:101-124): h = tanh(W h0); m, n = sigmoid gates;
  h <- h*m + (1-h)*n, a stabilized post-quantum feature mixer
  (``si_gated_head_init`` builds its four layers as an ``nn.ModuleDict``,
  the JAX tree's leaf names; ``si_gated_head_apply`` runs it).
- CoupledAdaptiveWeighting (:142-156), for the Czochralski pipeline's
  ``physics_normalize="coupled"``: a trainable data-noise scale eps_d with
  the physics scale pinned at eps_p = eps_d * sqrt(target_ratio):
  total = l_data / (2 eps_d^2) + l_phys / (2 eps_p^2) + log(eps_d eps_p).
- ``SIChainCircuit``: the exact EstimatorQNN circuit of
  si_q_pinn_improved.py:277-287, data-reuploading per layer with the FOUR
  inputs reused cyclically (RY(x[i % 4]) on wire i), then RX/RZ weight
  sweeps, then a CZ chain, on the statevector engine.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import gates, measure
from ..ops import statevector as sv
from ..ops.gates import host_const
from . import nn_core as nc


def si_gated_head_init(in_dim: int, hidden: int, out_dim: int,
                       generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    """{post_dense, gate_m, gate_n, out}: Xavier-normal layers, zero bias."""
    return nn.ModuleDict({
        "post_dense": nc.linear_init(in_dim, hidden, generator),
        "gate_m": nc.linear_init(hidden, hidden, generator),
        "gate_n": nc.linear_init(hidden, hidden, generator),
        "out": nc.linear_init(hidden, out_dim, generator),
    })


def si_gated_head_apply(params, q_out: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(nc.linear_apply(params["post_dense"], q_out))
    m = torch.sigmoid(nc.linear_apply(params["gate_m"], h))
    n = torch.sigmoid(nc.linear_apply(params["gate_n"], h))
    h = h * m + (1.0 - h) * n
    return nc.linear_apply(params["out"], h)


class SIChainCircuit:
    """The EstimatorQNN hardware-efficient reuploading circuit
    (si_q_pinn_improved.py:277-287), batched and exactly ordered:

      per layer l (the weights run layer-major, qubit-minor, RX then RZ):
        RY(x[i % 4]) on wire i        (data reupload, 4 inputs recycled)
        RX(w), RZ(w)  on wire i
        CZ(i, i+1)    for i < n-1     (open chain, no ring closure)

    2 n L weight parameters; <Z_i> per-wire readout (the reference's
    SparsePauliOp observables), exact or shot-sampled. Differentiable to any
    order through the statevector. ``gate_counts_per_wire()`` feeds the
    depth-aware noise channel."""

    def __init__(self, n_qubits: int, n_layers: int, n_inputs: int = 4):
        self.n = n_qubits
        self.layers = n_layers
        self.n_inputs = n_inputs
        self.num_params = 2 * n_qubits * n_layers

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """0.01 N(0, 1) over the weight vector (the reference's
        initial_weights convention)."""
        return (0.01 * torch.randn(self.num_params, generator=generator)).to(device)

    def gate_counts_per_wire(self):
        counts = [self.layers * 3] * self.n  # RY reupload + RX + RZ a layer
        for i in range(self.n - 1):  # the CZ chain, once a layer
            counts[i] += self.layers
            counts[i + 1] += self.layers
        return tuple(counts)

    def cz_phases(self) -> np.ndarray:
        """[2^n] complex64: the open CZ chain's diagonal, one multiply a
        layer."""
        n = self.n
        idx = np.arange(1 << n)
        phases = np.zeros(1 << n, dtype=np.float32)
        for i in range(n - 1):
            phases += np.pi * (((idx >> (n - 1 - i)) & 1) * ((idx >> (n - 2 - i)) & 1))
        return np.exp(1j * phases).astype(np.complex64)

    def apply(
        self,
        weights: torch.Tensor,
        x: torch.Tensor,
        *,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        noise: Optional[measure.NoiseModel] = None,
    ) -> torch.Tensor:
        """``[B, n_inputs] -> [B, n]`` per-wire Z expectations."""
        if noise is not None:
            noise = noise.bind(self)
        n = self.n
        w2 = weights.reshape(self.layers, n, 2)
        cz = host_const(self.cz_phases(), x.device)
        state = sv.zero_state(x.shape[0], n, device=x.device)
        for l in range(self.layers):
            for i in range(n):
                state = sv.apply_1q(state, n, i, gates.ry(x[:, i % self.n_inputs]))
            for i in range(n):
                state = sv.apply_1q(state, n, i, gates.rx(w2[l, i, 0]))
                state = sv.apply_1q(state, n, i, gates.rz(w2[l, i, 1]))
            state = state * cz
        if shots is None:
            return measure.exact_z(state, n, noise)
        measure.check_key(shots, key)
        return measure.sampled_z(state, n, shots, key, noise)

    def __call__(self, weights, x, **kw):
        return self.apply(weights, x, **kw)


def coupled_weighting_init() -> nn.ParameterDict:
    """{log_eps_data: [1] zeros}, the JAX tree's ``loss_bal`` leaf."""
    return nn.ParameterDict({"log_eps_data": nn.Parameter(torch.zeros(1))})


def coupled_weighting_apply(params, l_data: torch.Tensor, l_phys: torch.Tensor,
                            target_ratio: float = 100.0) -> torch.Tensor:
    eps_data = torch.exp(params["log_eps_data"][0])
    eps_phys = eps_data * math.sqrt(target_ratio)
    return (0.5 / (eps_data**2) * l_data + 0.5 / (eps_phys**2) * l_phys
            + torch.log(eps_data * eps_phys))
