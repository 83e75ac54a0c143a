"""Block-fused circuit execution (port of qcpinn_tpu/ops/block_fused.py).

The wire set splits into a HIGH block (wires 0..hb-1) and a LOW block (the
rest); every maximal run of in-block gates fuses into one dense block
unitary:

    state[B, 2^n] -> s[B, H, L]
    hi-run:  s <- einsum('bkl,km->bml', s, U_hi)
    lo-run:  s <- einsum('bkl,lm->bkm', s, U_lo)
    diag:    s <- s * exp(i phi)

U_hi / U_lo are built per step by running the remapped sub-programs on an
identity batch. Gates that straddle the block boundary run as single ops on
the flat state. Everything is plain torch, differentiable to any order.
This is the plain engine of the port and the in-port reference for the
block-chain kernels (ops/block_kernel.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from . import program as prog
from .circuit import DVCircuit
from .diag_fusion import DiagRun, split_diag_run
from .program import Op


@dataclasses.dataclass(frozen=True)
class Segment:
    """One sequential step of the fused chain.

    After chain-shortening a 'blocks' segment may span several parameter
    layers (and the epilogue): ``parts`` lists (layer, hi_prog, lo_prog)
    sub-programs in application order, whose block unitaries compose by
    small [K, K] matmuls before the one big state einsum."""

    kind: str  # 'blocks' | 'diag' | 'op'
    layer: int  # parameter-layer index; -1 = epilogue (no params)
    hi_prog: Tuple[Op, ...] = ()
    lo_prog: Tuple[Op, ...] = ()
    run: Optional[DiagRun] = None
    op: Optional[Op] = None
    parts: Tuple = ()

    def block_parts(self):
        return self.parts or ((self.layer, self.hi_prog, self.lo_prog),)


def _remap(op: Op, shift: int) -> Op:
    if shift == 0:
        return op
    return Op(op.kind, tuple(w - shift for w in op.wires), op.pidx, op.const)


def compile_segments(
    circuit: DVCircuit, hb: int, split_local_diags: bool = False
) -> Tuple[Segment, ...]:
    """``split_local_diags``: a DiagRun whose phase separates across the
    hi/lo cut joins the surrounding block programs as per-block diagonal
    factors instead of standing as its own segment."""
    segs: List[Segment] = []

    def walk(program, layer):
        cur_hi: List[Op] = []
        cur_lo: List[Op] = []

        def flush():
            nonlocal cur_hi, cur_lo
            if cur_hi or cur_lo:
                segs.append(Segment("blocks", layer, tuple(cur_hi), tuple(cur_lo)))
                cur_hi, cur_lo = [], []

        for op in program:
            if isinstance(op, DiagRun):
                parts = split_diag_run(op, hb) if split_local_diags else None
                if parts is not None:
                    hi_run, lo_run = parts
                    if hi_run is not None:
                        cur_hi.append(hi_run)
                    if lo_run is not None:
                        cur_lo.append(lo_run)
                    continue
                flush()
                segs.append(Segment("diag", layer, run=op))
            elif all(w < hb for w in op.wires):
                cur_hi.append(op)
            elif all(w >= hb for w in op.wires):
                cur_lo.append(_remap(op, hb))
            else:  # straddles the block boundary
                flush()
                segs.append(Segment("op", layer, op=op))
        flush()

    for layer in range(circuit.layers):
        walk(circuit.program, layer)
    walk(circuit.epilogue, -1)
    return tuple(segs)


def merge_block_segments(segs: Tuple[Segment, ...]) -> Tuple[Segment, ...]:
    """Chain-shortening: fuse ADJACENT 'blocks' segments into one whose
    hi/lo unitaries compose by [K, K] matmuls, so each removed segment is a
    removed full-state matmul in both the forward and the backward."""
    out: List[Segment] = []
    for seg in segs:
        if seg.kind == "blocks" and out and out[-1].kind == "blocks":
            prev = out[-1]
            out[-1] = Segment(
                "blocks", prev.layer, parts=prev.block_parts() + seg.block_parts()
            )
        else:
            out.append(seg)
    return tuple(out)


def _block_unitary(nbits: int, program: Tuple[Op, ...], layer_params):
    """Dense [2^k, 2^k] with M[in, out]: the sub-program run on an identity
    batch of basis states (row i = U|i> as a row vector)."""
    eye = torch.eye(1 << nbits, dtype=torch.complex64, device=layer_params.device)
    return prog.apply_program(eye, nbits, program, layer_params)


class BlockFusedCircuit:
    """Block-fused exact-expectation circuit: [B, n_feat] -> [B, n].

    ``hi_bits`` defaults to a balanced split. ``merge`` selects the
    chain-shortened segment chain (default) or the raw one. The JAX
    engine's ``precision`` argument is not carried over: the port's state
    einsums always run in full f32 (TF32 is off package-wide, see
    ``qcpinn_tpu_torch/__init__.py``)."""

    def __init__(
        self,
        circuit: DVCircuit,
        hi_bits: Optional[int] = None,
        merge: bool = True,
    ):
        n = circuit.n
        if n < 2:
            raise ValueError("block fusion needs n >= 2")
        self.circuit = circuit
        self.hb = hi_bits if hi_bits is not None else (n + 1) // 2
        if not 1 <= self.hb < n:
            raise ValueError(f"hi_bits {self.hb} out of range for n={n}")
        self.lb = n - self.hb
        self.segments_raw = compile_segments(circuit, self.hb)
        self.segments = (
            merge_block_segments(
                compile_segments(circuit, self.hb, split_local_diags=True)
            )
            if merge
            else self.segments_raw
        )

    def segment_stats(self) -> dict:
        """Counts of full-state ops per evolve, before and after
        chain-shortening."""

        def count(segs):
            matmuls = sum(
                any(p[1] for p in seg.block_parts())
                + any(p[2] for p in seg.block_parts())
                for seg in segs if seg.kind == "blocks"
            )
            return {
                "segments": len(segs),
                "state_matmuls": int(matmuls),
                "diags": sum(1 for s in segs if s.kind == "diag"),
                "cross_ops": sum(1 for s in segs if s.kind == "op"),
            }

        return {"raw": count(self.segments_raw), "merged": count(self.segments)}

    def _layer_params(self, params):
        c = self.circuit
        if params.numel() != c.layers * c.params_per_layer:
            raise ValueError("block backend needs unbatched circuit parameters")
        p2 = params.reshape(c.layers, c.params_per_layer)
        return lambda layer: p2[layer] if layer >= 0 else p2[0, :0]

    # The amp-sharded wrapper's hook (parallel/sharded_block.py), where the
    # JAX engine re-pins the layout (``_constrain``): the high-block product,
    # a diagonal run's phases and a cross-block op, on ``s [B, H, L]`` (under
    # the wrapper, this rank's rows of H).

    def _hi_product(self, s, m):
        return torch.einsum("bkl,km->bml", s, m)

    def _diag_phases(self, run, layer_params):
        return run.phases(layer_params)

    def _cross_op(self, flat, op, layer_params):
        return prog.apply_program(flat, self.circuit.n, (op,), layer_params)

    def evolve(self, params, state):
        """Ansatz layers + epilogue on an arbitrary [B, 2^n] complex state."""
        lp = self._layer_params(params)
        b = state.shape[0]
        l = 1 << self.lb
        s = state.reshape(b, -1, l)
        for seg in self.segments:
            if seg.kind == "blocks":
                mh = ml = None
                for part_layer, hi_prog, lo_prog in seg.block_parts():
                    pp = lp(part_layer)
                    # the state applies M as [in, out]: sequential parts
                    # compose as M_first @ M_second
                    if hi_prog:
                        m = _block_unitary(self.hb, hi_prog, pp)
                        mh = m if mh is None else mh @ m
                    if lo_prog:
                        m = _block_unitary(self.lb, lo_prog, pp)
                        ml = m if ml is None else ml @ m
                if mh is not None:
                    s = self._hi_product(s, mh)
                if ml is not None:
                    s = torch.einsum("bkl,lm->bkm", s, ml)
            elif seg.kind == "diag":
                phi = self._diag_phases(seg.run, lp(seg.layer)).reshape(1, -1, l)
                s = s * torch.polar(torch.ones_like(phi), phi)
            else:  # cross-block single op
                s = self._cross_op(s.reshape(b, -1), seg.op, lp(seg.layer)).reshape(b, -1, l)
        return s.reshape(b, -1)

    def state(self, params, x):
        from . import statevector as sv

        return self.evolve(
            params, sv.encode_angle_product(x * self.circuit.input_scale, self.circuit.n)
        )

    def apply(self, params, x, *, shots=None, key=None, noise=None):
        """``[B, F] -> [B, n]`` ``<Z_w>``, with the readout modes of
        ``DVCircuit.apply``."""
        from . import measure
        from . import statevector as sv

        measure.check_key(shots, key)
        if noise is not None:
            noise = noise.bind(self.circuit)
        z = sv.z_expvals(self.state(params, x), self.circuit.n)
        return measure.read_z(z, shots=shots, key=key, noise=noise)

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)
