"""Amplitude-sharded statevector engine: the 2^n state split over the mesh's
'amp' axis (port of qcpinn_tpu/parallel/sharded_sv.py).

Layout: the state's amplitude axis is split over its leading ``a =
log2(A)`` wire bits (wire 0 = MSB): the rank at amp index s holds the
contiguous block of 2^(n-a) amplitudes whose leading bits equal s.

- gates on wires w >= a act on the local block (the ordinary engine);
- a 1-qubit gate on a sharded wire w < a exchanges blocks with the partner
  whose index differs in that bit (``collectives.exchange``, one send and
  receive) and combines locally;
- a 2-qubit gate with one or both wires sharded needs one or three
  exchanges;
- diagonal runs never communicate: the sharded bits are fixed for a rank,
  so the fused phase vector is computed on its block of basis states;
- ``<Z_w>`` is the block's signed probability mass, summed over 'amp'
  (``collectives.psum``).

Where JAX runs this inside one ``shard_map`` over the global batch, each
process here holds its own rows (the data axis's split, made once where the
batch is drawn: ``mesh.shard_batch``) and its amplitude block; every engine
below takes this rank's rows and returns them. ``<Z>`` leaves an engine
summed over 'amp', so every amp rank holds the same readout; the
collectives' backwards are their transposes, so the gradients the ranks
then average (``Mesh.mean_grads``) are the single-device ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gates, measure
from ..ops import statevector as sv
from ..ops.circuit import DVCircuit
from ..ops.diag_fusion import DiagRun
from ..ops.program import (FIXED_1Q, FIXED_2Q, PARAM_1Q, PARAM_1Q3, PARAM_2Q, _FIXED_1Q_MATS,
                           _FIXED_2Q_MATS, _PARAM_1Q_FNS, _PARAM_2Q_FNS)
from .collectives import exchange, psum


def shard_bits_of(axis_size: int) -> int:
    """``log2`` of the amp axis size; raises unless it is a power of 2."""
    a = int(axis_size).bit_length() - 1
    if (1 << a) != axis_size:
        raise ValueError(f"amp axis size {axis_size} must be a power of 2")
    return a


class ShardedOps:
    """Gate application on this rank's block of the state: ``n`` qubits,
    ``a`` sharded bits, ``axis`` the mesh's amp :class:`~.mesh.Axis` (its
    index is this rank's shard)."""

    def __init__(self, n: int, a: int, axis):
        if a < 0 or a > n:
            raise ValueError(f"bad shard bits a={a} for n={n}")
        if axis.size != 1 << a:
            raise ValueError(f"{a} shard bits on an amp axis of {axis.size}")
        self.n = n
        self.a = a
        self.axis = axis
        self.n_local = n - a
        self.A = 1 << a
        self._signs = {}

    @property
    def block(self) -> tuple:
        """(start, stop) of this rank's basis states."""
        size = 1 << self.n_local
        return self.axis.index * size, (self.axis.index + 1) * size

    def shard_bits(self) -> list:
        """This rank's sharded wire bits (wire order)."""
        idx = self.axis.index
        return [(idx >> (self.a - 1 - w)) & 1 for w in range(self.a)]

    def local_block(self, state: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full ``[B, 2^n]`` state."""
        lo, hi = self.block
        return state[:, lo:hi]

    def _exchange(self, local: torch.Tensor, wire: int) -> torch.Tensor:
        """The block of the partner differing in sharded ``wire``."""
        return exchange(local, self.axis, 1 << (self.a - 1 - wire))

    def _bit(self, wire: int) -> int:
        return (self.axis.index >> (self.a - 1 - wire)) & 1

    def apply_1q(self, local: torch.Tensor, wire: int, m) -> torch.Tensor:
        if wire >= self.a:
            return sv.apply_1q(local, self.n_local, wire - self.a, m)
        m = sv._as_gate(m, local)
        other = self._exchange(local, wire)
        bit = self._bit(wire)
        # this block holds the amplitudes whose bit is `bit`, the partner's
        # those whose bit is 1 - bit
        if m.ndim == 2:
            return m[bit, bit] * local + m[bit, 1 - bit] * other
        return m[:, bit, bit, None] * local + m[:, bit, 1 - bit, None] * other

    def apply_2q(self, local: torch.Tensor, wa: int, wb: int, u) -> torch.Tensor:
        """General 2-qubit gate, ``u`` [4, 4] (or [B, 4, 4]) in (wa, wb)
        order."""
        a = self.a
        if wa >= a and wb >= a:
            return sv.apply_2q(local, self.n_local, wa - a, wb - a, u)
        u = sv._as_gate(u, local)
        u4 = u.reshape(u.shape[:-2] + (2, 2, 2, 2))

        def coeff(i, j, k, l):
            c = u4[..., i, j, k, l]
            return c[:, None] if c.ndim == 1 else c

        if wa < a and wb < a:
            # both sharded: the three partner blocks; blk[(da, db)] holds the
            # amplitudes whose (wa, wb) bits are (ba ^ da, bb ^ db)
            ba, bb = self._bit(wa), self._bit(wb)
            ma, mb = 1 << (a - 1 - wa), 1 << (a - 1 - wb)
            blk = {(0, 0): local,
                   (1, 0): exchange(local, self.axis, ma),
                   (0, 1): exchange(local, self.axis, mb),
                   (1, 1): exchange(local, self.axis, ma | mb)}
            out = 0
            for (da, db), src in blk.items():
                out = out + coeff(ba, bb, ba ^ da, bb ^ db) * src
            return out
        # mixed: one sharded, one local; make wa the sharded one
        if wb < a:
            wa, wb = wb, wa
            u4 = u4.transpose(-4, -3).transpose(-2, -1)
        bs = self._bit(wa)
        other = self._exchange(local, wa)
        wl = wb - a
        b = local.shape[0]
        lo, hi = 1 << wl, 1 << (self.n_local - 1 - wl)
        mine = local.reshape(b, lo, 2, hi)
        them = other.reshape(b, lo, 2, hi)

        def c4(i, j, k, l):
            c = u4[..., i, j, k, l]
            return c[:, None, None] if c.ndim == 1 else c

        # target (bs, t) from (bs, s) mine and (bs ^ 1, s) theirs
        outs = [sum(c4(bs, t, bs ^ k, s) * src[:, :, s, :]
                    for k, src in enumerate((mine, them)) for s in range(2))
                for t in range(2)]
        return torch.stack(outs, dim=2).reshape(b, 1 << self.n_local)

    def apply_diag_run(self, local: torch.Tensor, run: DiagRun, params) -> torch.Tensor:
        """A fused diagonal run on this rank's block: the phases of its
        basis states (global bits = [shard bits, local bits]), no
        communication."""
        phi = run.phases(params, self.block)
        if phi.ndim == 1:
            phi = phi[None, :]
        return local * torch.polar(torch.ones_like(phi), phi)

    def apply_program(self, local: torch.Tensor, program, params) -> torch.Tensor:
        for op in program:
            if isinstance(op, DiagRun):
                local = self.apply_diag_run(local, op, params)
                continue
            k = op.kind
            if k in PARAM_1Q:
                local = self.apply_1q(local, op.wires[0], _PARAM_1Q_FNS[k](params[..., op.pidx[0]]))
            elif k in PARAM_1Q3:
                local = self.apply_1q(local, op.wires[0], gates.rot(
                    *(params[..., p] for p in op.pidx)))
            elif k in PARAM_2Q:
                local = self.apply_2q(local, op.wires[0], op.wires[1],
                                      _PARAM_2Q_FNS[k](params[..., op.pidx[0]]))
            elif k in FIXED_1Q:
                local = self.apply_1q(local, op.wires[0], _FIXED_1Q_MATS[k])
            elif k in FIXED_2Q:
                local = self.apply_2q(local, op.wires[0], op.wires[1], _FIXED_2Q_MATS[k])
            elif k == "u1q":
                local = self.apply_1q(local, op.wires[0], op.const)
            elif k == "u2q":
                local = self.apply_2q(local, op.wires[0], op.wires[1], op.const)
            else:  # pragma: no cover - guarded by Op.__post_init__
                raise ValueError(k)
        return local

    def z_signs(self, device) -> torch.Tensor:
        """``[2^(n-a), n]``: the Z sign of every wire on this rank's basis
        states (the sharded wires' columns constant)."""
        if device not in self._signs:
            lo, hi = self.block
            idx = np.arange(lo, hi, dtype=np.int64)
            bits = (idx[:, None] >> (self.n - 1 - np.arange(self.n))[None, :]) & 1
            with gates.untransformed():
                self._signs[device] = torch.as_tensor(
                    (1.0 - 2.0 * bits).astype(np.float32), device=device)
        return self._signs[device]

    def bilinear_z(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``Re <x|Z_w|y>`` for every wire, ``[B, n]``, of two sharded
        states: the block's share, summed over 'amp'."""
        prod = (torch.conj(x) * y).real.to(torch.float32)
        return psum(prod @ self.z_signs(prod.device), self.axis)

    def z_expvals(self, local: torch.Tensor) -> torch.Tensor:
        """``<Z_w>`` ``[B, n]`` of the sharded state, summed over 'amp'."""
        probs = (local * torch.conj(local)).real.to(torch.float32)
        return psum(probs @ self.z_signs(probs.device), self.axis)


def _ops_for(circuit: DVCircuit, mesh, amp_axis: str) -> ShardedOps:
    axis = mesh.axis(amp_axis)
    return ShardedOps(circuit.n, shard_bits_of(axis.size), axis)


def _evolve_local(circuit: DVCircuit, ops: ShardedOps, params, local):
    p2 = params.reshape(circuit.layers, circuit.params_per_layer)
    for layer in range(circuit.layers):
        local = ops.apply_program(local, circuit.program, p2[layer])
    return ops.apply_program(local, circuit.epilogue, p2[0, :0])


def make_sharded_circuit_apply(circuit: DVCircuit, mesh, amp_axis: str = "amp",
                               data_axis: str = "data"):
    """``apply(params, x) -> [B, n]`` ``<Z_w>`` with the statevector sharded
    over ``amp_axis``; ``x`` is this rank's rows of the batch (split over
    ``data_axis`` where it was drawn), the result the same rows, alike on
    every amp rank."""
    del data_axis  # the rows arrive split
    ops = _ops_for(circuit, mesh, amp_axis)
    if circuit.encoding not in ("angle", "amplitude"):
        raise ValueError(f"unsupported encoding: {circuit.encoding}")

    def apply(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if circuit.encoding == "amplitude":
            # the normalized zero-padded state's blocks are contiguous: each
            # rank keeps its slice (nn/DVQuantumLayer.py:177-180)
            local = ops.local_block(sv.encode_amplitude(x, circuit.n))
        else:
            # the zero state: only shard 0 holds |0...0>
            local = torch.zeros((x.shape[0], 1 << ops.n_local), dtype=sv.CDTYPE,
                                device=x.device)
            if ops.axis.index == 0:
                local[:, 0] = 1.0
            for w in range(circuit.n):
                local = ops.apply_1q(local, w, gates.rx(x[:, w] * circuit.input_scale))
        return ops.z_expvals(_evolve_local(circuit, ops, params, local))

    return apply


def make_sharded_evolve(circuit: DVCircuit, mesh, amp_axis: str = "amp",
                        data_axis: str = "data"):
    """``evolve(params, state) -> block``: ansatz layers and epilogue on a
    caller-prepared state ``[B, 2^n]`` (this rank's rows, every amplitude),
    evolving this rank's amplitude block and returning it, ``[B, 2^n / A]``
    (the ShardedOps layout). This is the tangent streams' composition point
    (``physics/streams.py``): the 6x-wide derivative-stream batch rides the
    sharded evolution and stays sharded; its ``<Z>`` bilinears are read
    block by block and summed over 'amp' (``ShardedOps.bilinear_z``)."""
    del data_axis
    ops = _ops_for(circuit, mesh, amp_axis)

    def evolve(params: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        return _evolve_local(circuit, ops, params, ops.local_block(state))

    evolve.ops = ops
    return evolve


class ShardedCircuit:
    """Quantum-block adapter around :func:`make_sharded_circuit_apply` with
    the fused-backend calling convention, so a solver routes its training
    through the amp-sharded engine (``model.use_sharded(mesh)``).
    Differentiable to any order (plain torch and differentiable
    collectives), so the nested-AD PDE operators work through it;
    :meth:`evolve` and :meth:`bilinear_z` let the tangent-stream residuals
    run their stacked streams through the sharded evolution. Shot sampling
    and noise act on the amp-summed ``<Z>``: every amp rank holds the same
    expectations and draws the same shots from the same generator.

    JAX's ``_pad_batch`` (its shard_map needs the batch divisible by the
    data axis) has no counterpart: the rows arrive split, any count a
    rank."""

    def __init__(self, circuit: DVCircuit, mesh, amp_axis: str = "amp",
                 data_axis: str = "data"):
        self.circuit = circuit
        self.mesh = mesh
        self._apply = make_sharded_circuit_apply(circuit, mesh, amp_axis, data_axis)
        self._evolve = make_sharded_evolve(circuit, mesh, amp_axis, data_axis)
        self.ops = self._evolve.ops

    def apply(self, params, x, *, shots=None, key=None, noise=None):
        measure.check_key(shots, key)
        if noise is not None:
            noise = noise.bind(self.circuit)
        return measure.read_z(self._apply(params, x), shots=shots, key=key, noise=noise)

    def evolve(self, params, state):
        """Ansatz layers and epilogue on a full ``[B, 2^n]`` state; returns
        this rank's amplitude block."""
        return self._evolve(params, state)

    def bilinear_z(self, x, y):
        return self.ops.bilinear_z(x, y)

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)
