"""The block-fused engine over an amplitude-sharded state (port of
qcpinn_tpu/parallel/sharded_block.py).

The block engine (``ops/block_fused.py``) runs a circuit as a handful of
dense ``[H, H]`` / ``[L, L]`` products over ``state.reshape(B, H, L)``. Here
the H (leading-bit) axis is split over the mesh's 'amp' axis, the layout of
the per-gate engine (``sharded_sv.py``: rank s holds the amplitudes whose
leading bits equal s), and this rank holds its rows of the batch. Where JAX
pins ``[B, H, L]`` to ``P(data, amp, None)`` and lets GSPMD insert the
collectives, the port's ``BlockFusedCircuit`` hooks do it by hand:

- lo-block products contract the local L axis: no communication;
- hi-block products contract the sharded H axis: an all-to-all trades H
  rows for L columns (``[B, H/A, L] -> [B, H, L/A]``), the ``[H, H]``
  product runs locally, and a second all-to-all trades back. When L has
  fewer columns than the axis has ranks (tiny states: ``lo_bits < log2
  A``) each rank multiplies its own rows into every output row and a
  reduce-scatter sums them (the transient is a full state, which only a
  tiny state can afford);
- fused diagonal runs take the phases of this rank's contiguous block of
  basis states; the rare cross-block op runs on the per-gate engine.

Global-view in JAX means the whole apply surface works sharded: shot
sampling and the NoiseModel act on the amp-summed ``<Z>``, and the engine is
differentiable to any order, so it composes with the tangent streams and the
nested-AD operators.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import measure
from ..ops import statevector as sv
from ..ops.block_fused import BlockFusedCircuit
from ..ops.circuit import DVCircuit
from .collectives import all_to_all, reduce_scatter
from .sharded_sv import ShardedOps, shard_bits_of


class _AmpBlock(BlockFusedCircuit):
    """The block engine on this rank's H rows, its hooks the amp
    collectives."""

    def __init__(self, circuit: DVCircuit, hi_bits: int, ops: ShardedOps):
        super().__init__(circuit, hi_bits=hi_bits)
        self.ops = ops

    def _hi_product(self, s, m):
        axis = self.ops.axis
        if s.shape[2] >= axis.size:
            t = all_to_all(s, axis, split_dim=2, cat_dim=1)  # [B, H, L / A]
            return all_to_all(torch.einsum("bkl,km->bml", t, m), axis, split_dim=1, cat_dim=2)
        rows = s.shape[1]
        mine = m[axis.index * rows:(axis.index + 1) * rows]
        partial = torch.einsum("bkl,km->mbl", s, mine)  # every output row
        return reduce_scatter(partial, axis).transpose(0, 1)

    def _diag_phases(self, run, layer_params):
        return run.phases(layer_params, self.ops.block)

    def _cross_op(self, flat, op, layer_params):
        return self.ops.apply_program(flat, (op,), layer_params)


class ShardedBlockCircuit:
    """Amp-sharded block engine: the interface of BlockFusedCircuit
    (``evolve`` / ``state`` / ``apply``), on this rank's rows and amplitude
    block.

    ``hi_bits`` must put at least ``log2(amp)`` wires in the high block so
    the H axis divides over the mesh; the default balanced split is bumped
    up if needed. When even the bump leaves no low block (an amp axis as
    large as the state, e.g. amp=8 at n=3), the constructor raises with the
    remedy."""

    def __init__(self, circuit: DVCircuit, mesh, amp_axis: str = "amp",
                 data_axis: str = "data", hi_bits: Optional[int] = None):
        del data_axis  # the rows arrive split
        axis = mesh.axis(amp_axis)
        A = axis.size
        a = shard_bits_of(A)
        n = circuit.n
        hb = hi_bits if hi_bits is not None else max((n + 1) // 2, a)
        if hb >= n:
            raise ValueError(
                f"an amp axis of {A} devices needs at least {a} high bits, "
                f"but a {n}-qubit state has no low block left at hi_bits="
                f"{hb}; use fewer amp devices (or more qubits)"
            )
        if (1 << hb) % A:
            raise ValueError(f"hi_bits={hb} puts {1 << hb} rows on an amp axis of {A}")
        self.circuit = circuit
        self.mesh = mesh
        self.ops = ShardedOps(n, a, axis)
        self.block = _AmpBlock(circuit, hb, self.ops)

    def evolve(self, params: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """Ansatz layers and epilogue on a prepared ``[B, 2^n]`` state (this
        rank's rows, every amplitude); returns this rank's amplitude block
        ``[B, 2^n / A]`` (the tangent-stream composition point)."""
        return self.block.evolve(params, self.ops.local_block(state))

    def state(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        c = self.circuit
        if c.encoding == "amplitude":
            prepared = sv.encode_amplitude(x, c.n)
        else:
            prepared = sv.encode_angle_product(x * c.input_scale, c.n)
        return self.evolve(params, prepared)

    def bilinear_z(self, x, y):
        return self.ops.bilinear_z(x, y)

    def apply(self, params, x, *, shots=None, key=None, noise=None):
        measure.check_key(shots, key)
        if noise is not None:
            noise = noise.bind(self.circuit)
        z = self.ops.z_expvals(self.state(params, x))
        return measure.read_z(z, shots=shots, key=key, noise=noise)

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)
