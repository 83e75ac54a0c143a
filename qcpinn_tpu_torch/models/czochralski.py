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
applied to the state by the wire-group product (``ops/wire_group.py``: on
the card a hand-written kernel each way, where JAX leaves it to XLA's
einsum); the data reupload is one diagonal phase with per-sample angles;
the CZ brickwork one static phase vector. The rest is plain torch, TF32
off.

``Hybrid16QPINN.jet`` carries the prediction with its first and second
derivatives along r and z through one pass, the circuit as a jet of five
states (``CzQuantumLayer.apply(..., tangents=)``): the Cz residual's
derivatives with no nested ``torch.func.jvp``.
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
from ..ops import gates, measure, wire_group
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
    [wire0, wire0+k); u is [G, G] (shared) or [B, G, G] (per-sample). On
    the card one kernel each way (``ops/wire_group.py``)."""
    return wire_group.product(state, u.to(state.dtype), n, wire0)


def _wire_groups(n: int, k: int = 4):
    """[(wire0, size), ...] covering n wires in adjacent groups of <= k."""
    return [(w, min(k, n - w)) for w in range(0, n, k)]


@functools.lru_cache(maxsize=32)
def _z_sign_pairs(n: int, device: torch.device) -> torch.Tensor:
    """``sv.z_sign``'s rows, each twice: ``[2^(n+1), n]``, against a state's
    ``torch.view_as_real`` pairs (real and imaginary part of an
    amplitude)."""
    with gates.untransformed():
        return torch.repeat_interleave(sv.z_sign(n, device), 2, dim=0)


# -- the circuit as a second-order forward jet -----------------------------------
# A state jet is one tensor [1 + 2m, B, 2^n]: the state, its first derivative
# along each of m directions, then its second along each of them (the
# layout of nn_core's jets, the primal in front).


def _jet_product(a: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """The jet of the product ``a b`` (broadcasting) from its factors' jets:
    ``(ab)_k = a_k b + a b_k``, ``(ab)_kk = a_kk b + 2 a_k b_k + a b_kk``."""
    out = a * b[:1]
    out[1:] += a[:1] * b[1:]
    out[1 + m:] += 2.0 * a[1:1 + m] * b[1:1 + m]
    return out


def _encode_jet(a: torch.Tensor, m: int) -> torch.Tensor:
    """The RY encode of |0...0> as a jet, from the angles' jet ``a [1 + 2m,
    B, n]``: the product over wires (wire 0 the most significant bit) of
    ``v = (cos(a/2), sin(a/2))``, whose ``v_k = a_k v'`` and ``v_kk = a_kk
    v' - a_k^2 v / 4``, ``v' = (-sin(a/2), cos(a/2)) / 2``. Real ``[1 + 2m,
    B, 2^n]``: the krons run as a balanced tree, so the full width is
    formed once."""
    h = 0.5 * a[0]
    cos, sin = torch.cos(h), torch.sin(h)
    v = torch.stack([cos, sin], dim=-1)
    dv = 0.5 * torch.stack([-sin, cos], dim=-1)
    a1, a2 = a[1:1 + m, ..., None], a[1 + m:, ..., None]
    wires = torch.cat([v[None], a1 * dv, a2 * dv - 0.25 * a1 * a1 * v])  # [1 + 2m, B, n, 2]

    def kron(lo, hi):
        if hi - lo == 1:
            return wires[:, :, lo]
        mid = (lo + hi) // 2
        left, right = kron(lo, mid), kron(mid, hi)
        return _jet_product(left[..., :, None], right[..., None, :], m).flatten(2)

    return kron(0, a.shape[2])


def _phase_jet(s: torch.Tensor, phi: torch.Tensor, m: int) -> torch.Tensor:
    """The jet of ``s exp(i phi)`` from the state's jet and the real
    phase's (``[1 + 2m, B, 2^n]`` each). With ``t = s exp(i phi)`` channel by
    channel: ``out_k = t_k + i phi_k t``, ``out_kk = t_kk + i phi_kk t + i
    phi_k (t_k + out_k)``."""
    t = s * torch.exp(1j * phi[0])
    g = phi[1:] * (1j * t[0])
    first = t[1:1 + m] + g[:m]
    second = t[1 + m:] + g[m:] + phi[1:1 + m] * (1j * (t[1:1 + m] + first))
    return torch.cat([t[:1], first, second])


def _z_jet(state: torch.Tensor, n: int, m: int):
    """``<Z_w>`` ``[B, n]`` and its tangents ``[2m, B, n]`` from a state's
    jet: ``z = |psi|^2 . zs``, ``z_k = 2 Re(conj(psi) psi_k) . zs``, ``z_kk =
    (2 Re(conj(psi) psi_kk) + 2 |psi_k|^2) . zs``. Each ``Re(conj(a) b)`` is
    the product of ``a``'s and ``b``'s real pairs, summed by the product
    with ``zs``'s doubled rows: no ``conj``."""
    if not state.is_complex():  # the encode alone, with no layer
        state = state.to(sv.CDTYPE)
    c, b = state.shape[:2]
    r = torch.view_as_real(state).reshape(c, b, -1)
    zs = _z_sign_pairs(n, state.device)
    p = (r[:1] * r) @ zs
    q = (r[1:1 + m] * r[1:1 + m]) @ zs
    return p[0], 2.0 * torch.cat([p[1:1 + m], p[1 + m:] + q])


def _under_transform() -> bool:
    """True inside a ``torch.func`` transform (jvp, vmap, grad)."""
    return torch._C._functorch.maybe_current_level() is not None


class CzQuantumLayer:
    """The 16-qubit data-reuploading circuit, natively batched. Holds no
    tensor: its weights ``[L, n, 3]`` are the model's ``q``.

    ``remat`` runs the encoding and each reupload layer as its own
    ``torch.utils.checkpoint`` segment (non-reentrant), where JAX wraps each
    in ``jax.checkpoint``: reverse mode then holds one segment's per-gate
    ``[B, 2^n]`` intermediates at a time, the jet's ``[5, B, 2^n]`` ones too.
    ``torch.utils.checkpoint`` does not compose with ``torch.func.jvp`` (the
    recomputation runs outside the jvp levels and saves other tensors), so
    inside a ``torch.func`` transform the segments run unwrapped; the
    pipeline runs the nested-jvp residual in chunks of rows instead
    (``train/cz_pipeline.py``).

    The last layer's RZ(omega) of each wire meets only the diagonal CZ
    brickwork and the Z readout after it. So no readout depends on it
    (exact, sampled or noisy: each reads ``|psi|^2`` or a per-wire scale of
    it), nor any derivative of one: its exact gradient is 0. Rounding gives
    it noise instead (about 1e-8 of the 16q pretrain step's clipped
    gradient), which Adam's epsilon turns into steps of a few tenths of the
    learning rate. The jet (``tangents``, the pretrain residual's path)
    takes no gradient through it. A call without tangents keeps the
    gradient that rounding gives it, as the JAX package does, in every path
    (the data forward, finetune, eval, parameter-shift, the nested-jvp and
    reverse residuals, amp sharding)."""

    def __init__(self, n_qubits: int = 16, n_layers: int = 2, remat: bool = False):
        self.n = n_qubits
        self.layers = n_layers
        self.remat = remat
        # the amp-sharded layout (Hybrid16QPINN.use_sharded): a
        # parallel.sharded_sv.ShardedOps, or None for the whole state here
        self.sharded = None

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

    def _apply_group(self, st, w0, mats):
        """The kron of one-wire gates ``mats`` on wires [w0, w0 + len).
        Sharded, the group's sharded wires take their gate by a partner
        exchange each (``ShardedOps.apply_1q``) and its local wires the
        smaller kron on the local block: the factors commute, and no wire
        swap is needed whatever the group covers."""
        ops = self.sharded
        if ops is None:
            return _apply_wire_group(st, self.n, w0, _kron_chain(mats))
        split = min(max(ops.a - w0, 0), len(mats))
        for i in range(split):
            st = ops.apply_1q(st, w0 + i, mats[i])
        if split < len(mats):
            st = _apply_wire_group(st, ops.n_local, w0 + split - ops.a, _kron_chain(mats[split:]))
        return st

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
        key: Optional[measure.Key] = None,
        noise: Optional[measure.NoiseModel] = None,
        enc_off: Optional[torch.Tensor] = None,
        reup_off: Optional[torch.Tensor] = None,
        tangents: Optional[torch.Tensor] = None,
    ):
        """``<Z_w>`` ``[B, n]`` of the circuit on angles ``x [B, n]``.
        ``enc_off [n]`` / ``reup_off [layers, n]`` add to the RY-encoding
        angles / the per-wire reupload RZ angles: the per-occurrence shifts
        of the parameter-shift input gradient (train/hardware_grad.py).

        ``tangents [2m, B, n]``, the angles' first derivatives along m
        directions and then their second along each (``nn_core``'s jet
        layout), makes the call the circuit's second-order forward jet:
        returns (``<Z_w>``, its tangents ``[2m, B, n]``), every gate applied
        to the ``1 + 2m`` channels of the state at once. Exact readout of the
        whole state only: no shots, noise, shifts or amp sharding.

        With ``shots`` the readout is sampled from ``key``: keyed draws
        (``measure.ShotKey``) as evaluation 0, the forward of the
        parameter-shift estimator, or a ``torch.Generator``'s."""
        if tangents is not None:
            if any(v is not None for v in (shots, noise, enc_off, reup_off, self.sharded)):
                raise ValueError("the circuit's jet takes the exact readout of the whole "
                                 "state: no shots, noise, shifts or amp sharding")
            return self._jet(weights, x, tangents)
        n = self.n
        if noise is not None:
            noise = noise.bind(self)
        bits, brick = _constants(n, x.device)
        ops = self.sharded
        if ops is not None:
            # this rank's block of basis states
            lo, hi = ops.block
            bits, brick = bits[lo:hi], brick[lo:hi]
        groups = _wire_groups(n)

        def encode(xx):
            if ops is None:
                st = sv.zero_state(xx.shape[0], n, device=xx.device)
            else:
                # only shard 0 holds |0...0>
                st = torch.zeros((xx.shape[0], 1 << ops.n_local), dtype=sv.CDTYPE,
                                 device=xx.device)
                if ops.axis.index == 0:
                    st[:, 0] = 1.0
            for w0, k in groups:
                mats = [gates.ry(xx[:, w] if enc_off is None else xx[:, w] + enc_off[w])
                        for w in range(w0, w0 + k)]
                st = self._apply_group(st, w0, mats)
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
                st = self._apply_group(st, w0, [gates.rot(wl[i, 0], wl[i, 1], wl[i, 2])
                                                for i in range(w0, w0 + k)])
            return st * brick[None, :]

        state = self._segment(encode, x)
        for layer in range(self.layers):
            state = self._segment(functools.partial(one_layer, layer=layer),
                                  state, x, weights[layer])
        if ops is not None:
            # <Z> summed over 'amp': alike on every amp rank, so are the
            # shots, keyed or drawn from a generator seeded alike
            measure.check_key(shots, key)
            return measure.read_z(ops.z_expvals(state), shots=shots, key=key, noise=noise)
        if shots is None:
            return measure.exact_z(state, n, noise)
        measure.check_key(shots, key)
        return measure.sampled_z(state, n, shots, key, noise)

    def _jet(self, weights: torch.Tensor, x: torch.Tensor, tangents: torch.Tensor):
        """``apply``'s jet (see there). The encode is the product state of
        the wires' RY jets; a reupload phase depends on x, so its jet mixes
        the channels (``_phase_jet``); the Rot groups and the brickwork
        depend on the weights alone and act on every channel as a batch of
        ``(1 + 2m) B`` states. The last layer's RZ(omega) is cut from
        autograd (see the class)."""
        n, m = self.n, tangents.shape[0] // 2
        bits, brick = _constants(n, x.device)
        groups = _wire_groups(n)
        xj = torch.cat([x[None], tangents])

        def one_layer(st, xj, wl, layer):
            theta = 0.5 * torch.roll(xj, -layer, dims=2)
            phi = theta @ bits.T - 0.5 * torch.sum(theta, dim=2, keepdim=True)
            st = _phase_jet(st, phi, m)
            c, b = st.shape[:2]
            st = st.reshape(c * b, 1 << n)
            omega = wl[:, 2].detach() if layer == self.layers - 1 else wl[:, 2]
            for w0, k in groups:
                st = _apply_wire_group(st, n, w0, _kron_chain(
                    [gates.rot(wl[i, 0], wl[i, 1], omega[i]) for i in range(w0, w0 + k)]))
            return (st * brick[None, :]).reshape(c, b, 1 << n)

        state = self._segment(functools.partial(_encode_jet, m=m), xj)
        for layer in range(self.layers):
            state = self._segment(functools.partial(one_layer, layer=layer),
                                  state, xj, weights[layer])
        return _z_jet(state, n, m)


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
        key: Optional[measure.Key] = None,
        noise: Optional[measure.NoiseModel] = None,
        q_apply=None,
    ) -> torch.Tensor:
        """``q_apply(weights, q_in, key) -> [B, n]`` overrides the circuit
        call: how the parameter-shift estimator
        (``hardware_grad.make_hw_apply_cz``) plugs in for full-scope
        shot-noise training.

        The circuit call is the span ``engine``; with spans on, its reverse
        pass is the span ``engine.bwd``, marked at its output and at its
        input: ``q_in`` where it reports a gradient, else the weights (a
        tensor inside ``torch.func.jvp`` reports none)."""
        h = self.encode(x)
        q_in = math.pi * torch.tanh(nc.mlp_apply(self.to_quantum, h))
        if q_apply is not None:
            q_out = self._engine(q_in, lambda w, q: q_apply(w, q, key))
        else:
            q_out = self._engine(q_in, lambda w, q: self.qlayer.apply(
                w, q, shots=shots, key=key, noise=noise))
        if detach_quantum:
            q_out = q_out.detach()
        c_skip = torch.tanh(nc.mlp_apply(self.classical_skip, h))
        q_normed = nc.layernorm_apply(self.q_norm, q_out)
        return torch.cat([c_skip, q_normed, x], dim=-1)

    def _engine(self, q_in: torch.Tensor, call):
        """``call(weights, q_in)``, the circuit, as the span ``engine``; its
        reverse pass the span ``engine.bwd``, marked at the output (the
        primal ``<Z>`` of a jet) and at the input: ``q_in`` where it reports
        a gradient, else the weights (a tensor inside ``torch.func.jvp``
        reports none)."""
        # imported here: the utils package imports the train package, which
        # imports this module
        from ..utils import spans

        weights = self.q
        if q_in.requires_grad:
            q_in = spans.reverse_end("engine.bwd", q_in)
        else:
            weights = spans.reverse_end("engine.bwd", weights)
        with spans.span("engine", q_in):
            out = call(weights, q_in)
        if isinstance(out, tuple):
            return (spans.reverse_begin("engine.bwd", out[0]),) + out[1:]
        return spans.reverse_begin("engine.bwd", out)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        raw = nc.mlp_apply(self.post, self.quantum_features(x, **kw))
        # hard axis constraints: u_r, u_theta vanish on the axis (:140-147)
        r = x[:, 0:1]
        return torch.cat([r * raw[:, 0:1], raw[:, 1:2], r * raw[:, 2:3], raw[:, 3:4],
                          raw[:, 4:5]], dim=1)

    def jet(self, x: torch.Tensor):
        """``forward`` with its first derivative along each input column
        and its second along each, in one pass (``nn_core``'s jets, the
        circuit's through ``CzQuantumLayer.apply(tangents=)``, the span
        ``engine`` and its marks as in :meth:`quantum_features`): (out [B,
        5], tangents [4, B, 5]: d/dr, d/dz, d2/dr2, d2/dz2)."""
        cols2 = range(2)
        ff, t_ff = nc.fourier_features_jet(self.B, x, cols2)
        h = torch.cat([x, ff], dim=-1)
        th = torch.cat([nc.input_jet(x, cols2), t_ff], dim=-1)
        for layer in self.coord_proj:
            h, th = nc.tanh_jet(*nc.linear_jet(layer, h, th), cols2)
        for block in (self.res1, self.res2):
            a, ta = nc.tanh_jet(*nc.linear_jet(block[0], h, th), cols2)
            b, tb = nc.linear_jet(block[1], a, ta)
            h, th = nc.tanh_jet(h + b, th + tb, cols2)
        a, ta = nc.tanh_jet(*nc.linear_jet(self.to_quantum[0], h, th), cols2)
        q_in, t_in = nc.tanh_jet(*nc.linear_jet(self.to_quantum[1], a, ta), cols2)
        t_in = math.pi * t_in
        z, tz = self._engine(math.pi * q_in,
                             lambda w, q: self.qlayer.apply(w, q, tangents=t_in))
        skip, t_skip = nc.tanh_jet(*nc.linear_jet(self.classical_skip[0], h, th), cols2)
        zn, t_zn = nc.layernorm_jet(self.q_norm, z, tz, cols2)
        h = torch.cat([skip, zn, x], dim=-1)
        th = torch.cat([t_skip, t_zn, nc.input_jet(x, cols2)], dim=-1)
        for layer in self.post[:-1]:
            h, th = nc.tanh_jet(*nc.linear_jet(layer, h, th), cols2)
        raw, t_raw = nc.linear_jet(self.post[-1], h, th)
        # hard axis constraints, r * raw for u_r and u_theta: r's only
        # tangent is 1 along r, so (r raw)_r = raw + r raw_r and
        # (r raw)_rr = 2 raw_r + r raw_rr
        r = x[:, 0:1]

        def by_r(v, tv):
            zero = torch.zeros_like(v)[None]
            return r * v, r * tv + torch.cat([v[None], zero, 2.0 * tv[:1], zero])

        u_r, t_ur = by_r(raw[:, 0:1], t_raw[..., 0:1])
        u_t, t_ut = by_r(raw[:, 2:3], t_raw[..., 2:3])
        return (torch.cat([u_r, raw[:, 1:2], u_t, raw[:, 3:]], dim=1),
                torch.cat([t_ur, t_raw[..., 1:2], t_ut, t_raw[..., 3:]], dim=-1))

    def use_sharded(self, mesh, amp_axis: str = "amp",
                    data_axis: str = "data") -> "Hybrid16QPINN":
        """Shard the circuit's ``[B, 2^n]`` statevector over the mesh: this
        rank's rows of the batch (split over ``data_axis`` where the batch is
        drawn), the amplitude dimension (leading wire bits) over
        ``amp_axis``, as the per-gate engine lays it out
        (``parallel/sharded_sv.py``). The diagonal phases stay local; a wire
        group with sharded wires exchanges with partners (see
        ``CzQuantumLayer._apply_group``); ``<Z>`` is summed over 'amp'.
        Composes with remat, shots and noise and the pipeline's data-parallel
        batch."""
        from ..parallel.sharded_sv import ShardedOps, shard_bits_of

        del data_axis  # the rows arrive split
        axis = mesh.axis(amp_axis)
        self.qlayer.sharded = ShardedOps(self.n, shard_bits_of(axis.size), axis)
        return self

    @staticmethod
    def head_param_filter(model: nn.Module) -> dict:
        """Trainability mask for IBM-style head tuning
        (freeze_for_ibm_head_tuning, :149-155): parameter name -> whether it
        trains; only ``post`` does."""
        return {name: name.split(".")[0] == "post" for name, _ in model.named_parameters()}
