"""The flagship 16-qubit Czochralski hybrid PINN (port of
qcpinn_tpu/models/czochralski.py; CG_HQPINN_IBMtest_16qubits.py:52-160).

Architecture:
  FourierFeatures(2 -> 48, scale 6)                       :52-59
  coord_proj: Linear(50,128) Tanh Linear(128,128) Tanh    :89-94
  ResidualMLP(128) x 2                                    :62-73
  to_quantum: Linear(128,64) Tanh Linear(64,16); pi*tanh  :98-102,:127
  quantum: 16-qubit data-reuploading circuit              :217-235
           RY(x_i) encode; per layer RZ(0.5 x_{(i+l)%n}) +
           Rot(w_l,i) + even/odd CZ brickwork + ring CZ
  classical skip: Linear(128,64) Tanh                     :103-106
  LayerNorm on quantum features                           :109
  post: Linear(64+16+2,128) Tanh Linear(128,64) Tanh Linear(64,5)  :110-116
  hard axis constraints: u_r, u_theta scaled by r         :136-147

The circuit is natively batched, as in the JAX package: the per-wire RY
encoding and the Rot sweep are one 16x16 kron unitary a 4-wire group,
applied by one complex matmul over the state; the data reupload is one
diagonal phase with per-sample angles; the CZ brickwork one static phase
vector. No kernel of the package is on this path (JAX leaves it to XLA's
matmuls and elementwise ops): plain torch, TF32 off.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops import gates, measure
from ..ops import statevector as sv
from ..ops.diag_fusion import bit_matrix
from . import nn_core as nc


@functools.lru_cache(maxsize=8)
def _cz_brickwork_phases(n: int) -> np.ndarray:
    """Static [2^n] phase vector of the full CZ brickwork (even pairs, odd
    pairs, ring closure [n-1, 0]): CZ adds pi when both bits are 1."""
    bits = bit_matrix(n)
    pairs = [(i, i + 1) for i in range(0, n - 1, 2)]
    pairs += [(i, i + 1) for i in range(1, n - 1, 2)]
    pairs.append((n - 1, 0))
    phi = np.zeros(1 << n, dtype=np.float32)
    for a, b in pairs:
        phi += np.pi * bits[:, a] * bits[:, b]
    return phi


@functools.lru_cache(maxsize=32)
def _constants(n: int, device: torch.device):
    """(bit matrix [2^n, n] f32, brickwork phase factors exp(i phi) [2^n]
    complex64) on ``device``, built once outside any ``torch.func``
    transform (a constant made inside a nested jvp fails once that level
    exits)."""
    with gates.untransformed():
        bits = torch.as_tensor(bit_matrix(n), device=device)
        phi = torch.as_tensor(_cz_brickwork_phases(n), device=device)
        return bits, torch.exp(1j * phi)


def _kron_chain(mats):
    """Kronecker product of [..., 2, 2] gate matrices (first = group MSB)
    -> [..., 2^k, 2^k]."""
    u = mats[0]
    for m in mats[1:]:
        d = u.shape[-1]
        u = torch.einsum("...ij,...kl->...ikjl", u, m).reshape(
            *u.shape[:-2], 2 * d, 2 * d)
    return u


def _apply_wire_group(state, n, wire0, u):
    """Apply a 2^k x 2^k unitary on the adjacent wire group
    [wire0, wire0+k); u is [G, G] (shared) or [B, G, G] (per-sample)."""
    g = u.shape[-1]
    k = g.bit_length() - 1
    b = state.shape[0]
    s = state.reshape(b, 1 << wire0, g, 1 << (n - wire0 - k))
    eq = "bij,bljh->blih" if u.ndim == 3 else "ij,bljh->blih"
    return torch.einsum(eq, u.to(state.dtype), s).reshape(b, 1 << n)


def _wire_groups(n: int, k: int = 4):
    """[(wire0, size), ...] covering n wires in adjacent groups of <= k."""
    return [(w, min(k, n - w)) for w in range(0, n, k)]


def _under_transform() -> bool:
    """True inside a ``torch.func`` transform (jvp, vmap, grad)."""
    return torch._C._functorch.maybe_current_level() is not None


class CzQuantumLayer:
    """The 16-qubit data-reuploading circuit, natively batched. Holds no
    tensor: its weights ``[L, n, 3]`` are the model's ``q``.

    ``remat`` runs the encoding and each reupload layer as its own
    ``torch.utils.checkpoint`` segment (non-reentrant), where JAX wraps each
    in ``jax.checkpoint``: reverse mode then holds one segment's per-gate
    ``[B, 2^n]`` intermediates at a time. ``torch.utils.checkpoint`` does
    not compose with ``torch.func.jvp`` (the recomputation runs outside the
    jvp levels and saves other tensors), so inside a ``torch.func``
    transform the segments run unwrapped; the pipeline bounds the
    forward-mode residual's memory by running it in chunks of rows instead
    (``train/cz_pipeline.py``)."""

    def __init__(self, n_qubits: int = 16, n_layers: int = 2, remat: bool = False):
        self.n = n_qubits
        self.layers = n_layers
        self.remat = remat

    def init(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """TorchLayer's default init: U(0, 2 pi) over (L, n, 3)."""
        return 2 * math.pi * torch.rand((self.layers, self.n, 3), generator=generator)

    def gate_counts_per_wire(self):
        """Per-wire gate touches for the depth-aware noise channel
        (ops/measure.py): RY encode, then per layer one reupload RZ and one
        Rot a wire plus the even/odd CZ brickwork and ring closure
        (CG_HQPINN_IBMtest_16qubits.py:217-235)."""
        n = self.n
        counts = [1] * n
        cz_pairs = ([(i, i + 1) for i in range(0, n - 1, 2)]
                    + [(i, i + 1) for i in range(1, n - 1, 2)] + [(n - 1, 0)])
        for _ in range(self.layers):
            for w in range(n):
                counts[w] += 2
            for a, b in cz_pairs:
                counts[a] += 1
                counts[b] += 1
        return tuple(counts)

    def _segment(self, fn, *args):
        if self.remat and torch.is_grad_enabled() and not _under_transform():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def apply(
        self,
        weights: torch.Tensor,
        x: torch.Tensor,
        *,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        noise: Optional[measure.NoiseModel] = None,
        enc_off: Optional[torch.Tensor] = None,
        reup_off: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``<Z_w>`` ``[B, n]`` of the circuit on angles ``x [B, n]``.
        ``enc_off [n]`` / ``reup_off [layers, n]`` add to the RY-encoding
        angles / the per-wire reupload RZ angles: the per-occurrence shifts
        of the parameter-shift input gradient (train/hardware_grad.py)."""
        n = self.n
        if noise is not None:
            noise = noise.bind(self)
        bits, brick = _constants(n, x.device)
        groups = _wire_groups(n)

        def encode(xx):
            st = sv.zero_state(xx.shape[0], n, device=xx.device)
            for w0, k in groups:
                mats = [gates.ry(xx[:, w] if enc_off is None else xx[:, w] + enc_off[w])
                        for w in range(w0, w0 + k)]
                st = _apply_wire_group(st, n, w0, _kron_chain(mats))
            return st

        def one_layer(st, xx, wl, layer):
            # data reupload: RZ(0.5 * x[(i + layer) % n]) on wire i, one
            # batched diagonal phase (phi = theta.b - sum(theta)/2)
            theta = 0.5 * torch.roll(xx, -layer, dims=1)
            if reup_off is not None:
                theta = theta + reup_off[layer][None, :]
            phi = theta @ bits.T - 0.5 * torch.sum(theta, dim=1, keepdim=True)
            st = st * torch.exp(1j * phi)
            for w0, k in groups:
                u = _kron_chain([gates.rot(wl[i, 0], wl[i, 1], wl[i, 2])
                                 for i in range(w0, w0 + k)])
                st = _apply_wire_group(st, n, w0, u)
            return st * brick[None, :]

        state = self._segment(encode, x)
        for layer in range(self.layers):
            state = self._segment(functools.partial(one_layer, layer=layer),
                                  state, x, weights[layer])
        if shots is None:
            return measure.exact_z(state, n, noise)
        measure.check_key(shots, key)
        return measure.sampled_z(state, n, shots, key, noise)


class Hybrid16QPINN(nn.Module):
    """``model(x)`` is the JAX package's ``model.apply(params, x)``; the
    parameters live in the module, under the JAX tree's names (``B``, the
    Fourier matrix, is a buffer: JAX stops its gradient). The circuit is
    ``qlayer`` (JAX's ``model.q``), its weights the parameter ``q``. Weights
    are drawn from ``seed`` (``ff_seed`` for the Fourier matrix); torch does
    not replay ``jax.random``, so shared weights cross by the bridge."""

    def __init__(
        self,
        n_qubits: int = 16,
        n_layers: int = 2,
        ff_seed: int = 0,
        remat: bool = True,
        width: int = 128,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.n = n_qubits
        # remat=True segments the reverse-mode memory a reupload layer (see
        # CzQuantumLayer): B = 512 at 16 qubits otherwise holds every
        # per-gate state of the circuit
        self.qlayer = CzQuantumLayer(n_qubits, n_layers, remat=remat)
        self.ff_seed = ff_seed
        # width 128 is the reference's trunk (:89-94); wider trunks are an
        # accuracy lever (the velocity rel-L2 floor is capacity-limited)
        self.width = width
        n, w = n_qubits, width
        gen = torch.Generator().manual_seed(seed)
        self.register_buffer("B", nc.fourier_features_init(
            2, 24, 6.0, torch.Generator().manual_seed(ff_seed)))
        self.coord_proj = nc.mlp_init((2 + 48, w, w), gen)
        self.res1 = nc.mlp_init((w, w, w), gen)
        self.res2 = nc.mlp_init((w, w, w), gen)
        self.to_quantum = nc.mlp_init((w, 64, n), gen)
        self.classical_skip = nc.mlp_init((w, 64), gen)
        self.q = nn.Parameter(self.qlayer.init(gen))
        self.q_norm = nc.layernorm_init(n)
        self.post = nc.mlp_init((64 + n + 2, 128, 64, 5), gen)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def init(self, seed: int) -> "Hybrid16QPINN":
        """Draw every weight anew from ``seed``, in place (the tensors stay
        the same objects, so a captured step keeps them)."""
        fresh = Hybrid16QPINN(self.n, self.qlayer.layers, self.ff_seed, self.qlayer.remat,
                              self.width, seed, device="cpu")
        self.load_state_dict(fresh.state_dict())
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, nc.fourier_features_apply(self.B, x)], dim=-1)
        h = torch.tanh(nc.mlp_apply(self.coord_proj, h))  # L-T-L-T
        # ResidualMLP: act(x + block(x)), block = L-T-L (:62-73)
        h = torch.tanh(h + nc.mlp_apply(self.res1, h))
        return torch.tanh(h + nc.mlp_apply(self.res2, h))

    def quantum_features(
        self,
        x: torch.Tensor,
        *,
        detach_quantum: bool = False,
        shots: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        noise: Optional[measure.NoiseModel] = None,
        q_apply=None,
    ) -> torch.Tensor:
        """``q_apply(weights, q_in, key) -> [B, n]`` overrides the circuit
        call: how the parameter-shift estimator
        (``hardware_grad.make_hw_apply_cz``) plugs in for full-scope
        shot-noise training."""
        h = self.encode(x)
        q_in = math.pi * torch.tanh(nc.mlp_apply(self.to_quantum, h))
        if q_apply is not None:
            q_out = q_apply(self.q, q_in, key)
        else:
            q_out = self.qlayer.apply(self.q, q_in, shots=shots, key=key, noise=noise)
        if detach_quantum:
            q_out = q_out.detach()
        c_skip = torch.tanh(nc.mlp_apply(self.classical_skip, h))
        q_normed = nc.layernorm_apply(self.q_norm, q_out)
        return torch.cat([c_skip, q_normed, x], dim=-1)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        raw = nc.mlp_apply(self.post, self.quantum_features(x, **kw))
        # hard axis constraints: u_r, u_theta vanish on the axis (:140-147)
        r = x[:, 0:1]
        return torch.cat([r * raw[:, 0:1], raw[:, 1:2], r * raw[:, 2:3], raw[:, 3:4],
                          raw[:, 4:5]], dim=1)

    def use_sharded(self, mesh, amp_axis: str = "amp", data_axis: str = "data"):
        raise NotImplementedError(
            "the amplitude-sharded statevector is not yet ported (ROADMAP queue 1, "
            "parallel)")

    @staticmethod
    def head_param_filter(model: nn.Module) -> dict:
        """Trainability mask for IBM-style head tuning
        (freeze_for_ibm_head_tuning, :149-155): parameter name -> whether it
        trains; only ``post`` does."""
        return {name: name.split(".")[0] == "post" for name, _ in model.named_parameters()}
