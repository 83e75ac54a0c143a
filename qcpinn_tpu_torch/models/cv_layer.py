"""CV photonic quantum networks (port of qcpinn_tpu/models/cv_layer.py;
arXiv:1806.06871 eq. 26 structure), as an ``nn.Module``.

One class covers all three reference variants
(nn/CVNeuralNetwork{1,2,3}.py):

  variant 1: Displacement(x_i, 0) encoding; per layer
             [interferometer -> Squeezing -> interferometer ->
              Displacement + Kerr]; <n_w> readout.
  variant 2: same topology, init scales active_sd=0.1 / passive_sd=2pi,
             <x_w> (QuadOperator(phi=0)) readout.
  variant 3: variant 1 + CubicPhase per mode + CrossKerr over all pairs +
             learnable input-encoding scale/phase.

The Clements-style interferometer reproduces the reference's parity-skip
beamsplitter mesh exactly (nn/CVNeuralNetwork1.py:143-153): for sweep l and
neighbour pair k, a BS(theta_n, phi_n) is placed iff (l + k) % 2 != 1, then
Rotation(rphi_i) on the first max(1, m-1) modes.

Every dense gate of a forward is the exponential of its generator, and all
of them come out of two batched exponentials (``fock.expm``): one for the
d x d gates (the per-sample encoding displacements, ``[B, m]`` of them,
and every layer's squeezing, displacement and cubic phase), one for the
d^2 x d^2 beamsplitters of every interferometer. Rotation, Kerr and
CrossKerr are diagonal and multiply the state. The parameters keep the JAX
tree's leaf names (the bridge's ``cv`` group).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import fock


def interferometer_wiring(m: int):
    """Static (pair index, (q1, q2)) placement list for one interferometer."""
    placements = []
    n = 0
    for l in range(m):
        for k in range(m - 1):
            if (l + k) % 2 != 1:
                placements.append((n, (k, k + 1)))
                n += 1
    return placements


class CVLayer(nn.Module):
    def __init__(
        self,
        num_qumodes: int,
        num_layers: int,
        cutoff_dim: int = 6,
        variant: int = 1,
        hbar: float = 2.0,
        readout: Optional[str] = None,
        active_sd: Optional[float] = None,
        passive_sd: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``readout``/``active_sd``/``passive_sd`` default to the
        reference's per-variant choices (readout 'n' for v1/v3, 'x' for v2;
        sd per CVNeuralNetwork{1,2,3}); the overrides are the JAX package's
        (its round-5 diagnosis localized the v1/v3 stall to the
        <n>-at-vacuum readout geometry). The initial parameters are drawn
        from ``generator``, normal at the variant's scales."""
        super().__init__()
        if variant not in (1, 2, 3):
            raise ValueError(f"variant must be 1, 2 or 3, got {variant}")
        if readout not in (None, "n", "x"):
            raise ValueError(f"readout must be 'n' or 'x', got {readout!r}")
        self.m = num_qumodes
        self.layers = num_layers
        self.d = cutoff_dim
        self.variant = variant
        self.hbar = hbar
        self.readout = readout or ("x" if variant == 2 else "n")
        # max(1, m-1) rotations + m(m-1) BS params (theta & phi halves)
        self.n_interf = self.m * (self.m - 1) + max(1, self.m - 1)
        self.placements = interferometer_wiring(self.m)
        if self.m > 1 and len(self.placements) != self.m * (self.m - 1) // 2:
            raise AssertionError("the mesh places m(m-1)/2 beamsplitters")

        # active_sd / passive_sd per variant (CVNeuralNetwork1.py:24-25,
        # CVNeuralNetwork2.py:18-19, CVNeuralNetwork3.py init)
        if active_sd is None:
            active_sd = 0.1 if variant == 2 else 1e-4
        if passive_sd is None:
            passive_sd = 2 * math.pi if variant == 2 else 0.1
        L, m = self.layers, self.m

        def rnd(shape, sd):
            return nn.Parameter(sd * torch.randn(shape, generator=generator))

        self.theta_1 = rnd((L, self.n_interf), passive_sd)
        self.theta_2 = rnd((L, self.n_interf), passive_sd)
        self.squeezing_r = rnd((L, m), active_sd)
        self.squeezing_phi = rnd((L, m), passive_sd)
        self.displacement_r = rnd((L, m), active_sd)
        self.displacement_phi = rnd((L, m), passive_sd)
        self.kerr = rnd((L, m), active_sd)
        if variant == 3:
            self.cubic_phase = rnd((L, m), active_sd)
            self.cross_kerr = rnd((L, m, m), active_sd)
            self.input_scaling = nn.Parameter(torch.ones(m))
            self.input_phase = nn.Parameter(torch.zeros(m))

    # -- the gates -------------------------------------------------------------

    def _single_mode_gates(self, x: torch.Tensor):
        """(encoding [B, m, d, d], per-layer gates {name: [L, m, d, d]}) from
        one batched exponential."""
        m, d, L = self.m, self.d, self.layers
        if self.variant == 3:
            r = x * self.input_scaling
            phi = self.input_phase.expand_as(r)
        else:
            r, phi = x, torch.zeros_like(x)
        gens = [fock.displacement_generator(r, phi, d),
                fock.squeezing_generator(self.squeezing_r, self.squeezing_phi, d),
                fock.displacement_generator(self.displacement_r, self.displacement_phi, d)]
        names = ["squeezing", "displacement"]
        if self.variant == 3:
            gens.append(fock.cubic_phase_generator(self.cubic_phase, d, self.hbar))
            names.append("cubic_phase")
        flat = fock.expm(torch.cat([g.reshape(-1, d, d) for g in gens]))
        enc, rest = flat[: x.shape[0] * m], flat[x.shape[0] * m:]
        layer_gates = dict(zip(names, rest.reshape(len(names), L, m, d, d)))
        return enc.reshape(x.shape[0], m, d, d), layer_gates

    def _beamsplitters(self) -> torch.Tensor:
        """[L, 2, m(m-1)/2, d^2, d^2]: each interferometer's beamsplitters,
        theta_1's then theta_2's."""
        half = self.m * (self.m - 1) // 2
        angles = torch.stack([self.theta_1, self.theta_2], dim=1)  # [L, 2, n_interf]
        theta, phi = angles[..., :half], angles[..., half: 2 * half]
        return fock.expm(fock.beamsplitter_generator(theta, phi, self.d))

    def _interferometer(self, state, angles, bs):
        m, d = self.m, self.d
        rphi = angles[-max(1, m - 1):]
        for n, (q1, q2) in self.placements:
            state = fock.apply_2m(state, m, d, q1, q2, bs[n])
        for i in range(max(1, m - 1)):
            state = fock.apply_diag_1m(state, m, d, i, fock.rotation_diag(rphi[i], d))
        return state

    # -- forward ---------------------------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, m] inputs -> [B, m] expectations (<n> for v1/v3, <x> for v2),
        in the engine's real dtype."""
        m, d = self.m, self.d
        x = x.to(fock.FDTYPE)
        enc, gates = self._single_mode_gates(x)
        bs = self._beamsplitters() if m > 1 else None
        state = fock.vacuum(x.shape[0], m, d, device=x.device)
        for w in range(m):
            state = fock.apply_1m(state, m, d, w, enc[:, w])
        for l in range(self.layers):
            state = self._interferometer(state, self.theta_1[l], bs[l, 0] if m > 1 else None)
            for w in range(m):
                state = fock.apply_1m(state, m, d, w, gates["squeezing"][l, w])
            state = self._interferometer(state, self.theta_2[l], bs[l, 1] if m > 1 else None)
            for w in range(m):
                state = fock.apply_1m(state, m, d, w, gates["displacement"][l, w])
                state = fock.apply_diag_1m(state, m, d, w, fock.kerr_diag(self.kerr[l, w], d))
                if self.variant == 3:
                    state = fock.apply_1m(state, m, d, w, gates["cubic_phase"][l, w])
            if self.variant == 3:
                for i in range(m):
                    for j in range(i + 1, m):
                        table = fock.cross_kerr_diag(self.cross_kerr[l, i, j], d)
                        state = fock.apply_diag_2m(state, m, d, i, j, table)
        if self.readout == "x":
            return fock.quad_x_expvals(state, m, d, self.hbar)
        return fock.number_expvals(state, m, d)
