"""Block-chain kernels: the whole block-segment chain of one evolve in one
launch (port of qcpinn_tpu/ops/block_pallas.py).

``csrc/block_chain.cu`` holds two hand-written CUDA kernels for Hopper
(sm_90a) and a reduction pass:

- ``block_chain_fwd`` replaces ``block_pallas.py::_forward_kernel``. Each
  CTA keeps one sample's split re/im ``[H, L]`` state in shared memory for
  the whole chain, so the state is read and written once.
- ``block_chain_bwd`` replaces ``block_pallas.py::_backward_kernel``. It
  sweeps the plan in reverse with O(1) state memory: the matrices arrive
  conj-transposed, and one contraction with them both recovers each step's
  input and pulls the cotangent back. Its three complex products per mat
  step run on the tensor cores in 3xTF32 (a TF32 high and low part of each
  f32 operand, hi*hi + hi*lo + lo*hi in f32), on a tile of samples per
  CTA (:func:`bwd_config`). The matrix and phase cotangents are batch
  sums: each CTA sums its tile in registers, adds it into its own partial
  slab once a tile (one CTA per SM, so the slabs stay in L2), and
  ``block_chain_reduce`` adds the slabs in a fixed order (no float
  atomics, deterministic).

Bound: at 12 qubits (H = L = K = 64) every mat step is a 64x64x64 complex
product per sample, ~21 FMA per byte of state, so the kernels are bound by
arithmetic. Both keep the state on chip for the whole chain; the forward
gives each thread a 4x4 complex register tile on the FP32 units, on
bank-conflict-free padded rows.

The state keeps one ``[H, L]`` orientation throughout: the Pallas kernel's
transposes exist because Mosaic contracts only the minor dim, and the GPU
indexes the stepped axis directly. Phases and their cotangents are ``[H, L]``
as well, so the wrappers transpose nothing.

Each kernel has a plain PyTorch version beside it (``*_ref``), which runs
for CPU tensors (the tests) and, on the card, only in the tests and
``chip_smoke.py``. For a CUDA tensor a wrapper launches its kernel or
raises. ``LAUNCHES`` counts kernel launches and plain-version calls.

Parameter gradients flow outside the kernels: autograd chains the matrix
and phase cotangents through ``_block_unitary`` and ``DiagRun.phases``.
Reverse-mode AD only, which is what the tangent-stream residuals need.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .block_fused import BlockFusedCircuit, Segment, _block_unitary
from .circuit import DVCircuit

MAX_QUBITS = 12  # one sample's state must fit in one CTA's shared memory
MIN_BLOCK_BITS = 5  # the backward's tensor-core tiles are 32 rows deep
MAX_STEPS = 128  # QC_MAX_STEPS in csrc/block_chain.cu


LAUNCHES = {
    "block_chain_fwd": 0,
    "block_chain_bwd": 0,
    "block_chain_reduce": 0,
    "block_chain_fwd_ref": 0,
    "block_chain_bwd_ref": 0,
    "block_chain_reduce_ref": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plan ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KStep:
    kind: str  # 'mat' | 'diag'
    axis: str = ""  # 'hi' | 'lo' (mat only)
    idx: int = 0  # index into the mats / phases argument lists


@dataclasses.dataclass(frozen=True)
class KPlan:
    n: int
    hb: int
    lb: int
    steps: Tuple[KStep, ...]
    # step idx -> (segment position, axis) / segment position
    mat_srcs: Tuple[Tuple[int, str], ...]
    diag_srcs: Tuple[int, ...]

    @property
    def n_mats(self) -> int:
        return len(self.mat_srcs)

    @property
    def n_diags(self) -> int:
        return len(self.diag_srcs)

    def mat_dim(self, idx: int) -> int:
        return 1 << (self.hb if self.mat_srcs[idx][1] == "hi" else self.lb)


def build_plan(segments: Tuple[Segment, ...], n: int, hb: int) -> KPlan:
    """Flatten raw block segments into kernel steps. Raises if a segment
    straddles the block boundary. Within a 'blocks' segment the hi and lo
    products commute; they are ordered as the JAX plan orders them (the
    axis its layout walk has at the minor dim first), so both packages
    produce the same step list."""
    steps: List[KStep] = []
    mat_srcs: List[Tuple[int, str]] = []
    diag_srcs: List[int] = []
    layout = ("hi", "lo")
    for si, seg in enumerate(segments):
        if seg.parts:
            raise ValueError(
                "build_plan needs the unmerged segment chain; construct "
                "the engine with merge=False"
            )
        if seg.kind == "blocks":
            axes = [a for a, p in (("hi", seg.hi_prog), ("lo", seg.lo_prog)) if p]
            axes.sort(key=lambda a: 0 if layout[1] == a else 1)
            for a in axes:
                steps.append(KStep("mat", a, len(mat_srcs)))
                mat_srcs.append((si, a))
                if layout[0] == a:
                    layout = (layout[1], layout[0])
        elif seg.kind == "diag":
            steps.append(KStep("diag", idx=len(diag_srcs)))
            diag_srcs.append(si)
        else:
            raise ValueError(
                "block_kernel supports only in-block + diagonal segments; "
                f"got a boundary-straddling op {seg.op}"
            )
    return KPlan(n, hb, n - hb, tuple(steps), tuple(mat_srcs), tuple(diag_srcs))


def supports(circuit: DVCircuit, hi_bits: Optional[int] = None) -> bool:
    """True if the circuit's block decomposition has no boundary-straddling
    segment (BlockKernelCircuit can run it)."""
    probe = BlockFusedCircuit(circuit, hi_bits=hi_bits, merge=False)
    return all(seg.kind != "op" for seg in probe.segments)


# -- packed inputs -------------------------------------------------------------
#
# The kernels take their small inputs packed, as the C interface does: ``m``
# holds each mat's re [K, K] then im [K, K] in plan order, and ``p`` holds
# each diag's cos [H, L] then sin [H, L]. The cotangent slab of the backward
# is ``m``'s layout followed by ``p``'s.


def _unpack(flat: torch.Tensor, sizes: Sequence[Tuple[int, int]]):
    out, off = [], 0
    for d1, d2 in sizes:
        n = d1 * d2
        out.append((flat[off : off + n].view(d1, d2),
                    flat[off + n : off + 2 * n].view(d1, d2)))
        off += 2 * n
    return out


def unpack(plan: KPlan, m: torch.Tensor, p: torch.Tensor):
    """Views of packed mats and phases (or their cotangents) as (re, im)
    [K, K] and (cos, sin) [H, L] pairs in plan order."""
    mats = _unpack(m, [(plan.mat_dim(i),) * 2 for i in range(plan.n_mats)])
    phases = _unpack(p, [(1 << plan.hb, 1 << plan.lb)] * plan.n_diags)
    return mats, phases


def _pack(pairs) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for pair in pairs for t in pair])


@functools.lru_cache(maxsize=None)
def _conj_transpose_index(plan: KPlan, device: torch.device):
    perm, sign, off = [], [], 0
    for i in range(plan.n_mats):
        k = plan.mat_dim(i)
        t = np.arange(k * k).reshape(k, k).T.reshape(-1)
        perm += [off + t, off + k * k + t]
        sign += [np.ones(k * k), -np.ones(k * k)]
        off += 2 * k * k
    return (torch.as_tensor(np.concatenate(perm), device=device),
            torch.as_tensor(np.concatenate(sign), dtype=torch.float32, device=device))


def conj_transpose(plan: KPlan, m: torch.Tensor) -> torch.Tensor:
    """Packed conj(M)^T of packed mats: what the backward takes."""
    perm, sign = _conj_transpose_index(plan, m.device)
    return m[perm] * sign


# -- plain PyTorch versions ----------------------------------------------------


def _contract(sr, si, mr, mi, axis: str):
    """Complex-contract the state's hi (dim 1) or lo (dim 2) axis with
    M[k, m]."""
    eq = "bkl,km->bml" if axis == "hi" else "bhk,km->bhm"

    def dot(x, m):
        return torch.einsum(eq, x, m)

    return dot(sr, mr) - dot(si, mi), dot(sr, mi) + dot(si, mr)


def block_chain_fwd_ref(xr, xi, m, p, plan: KPlan):
    """Plain version of the forward kernel. xr/xi: [B, H, L] f32; m, p:
    packed mats and phases. Returns (yr, yi) [B, H, L]."""
    LAUNCHES["block_chain_fwd_ref"] += 1
    mats, phases = unpack(plan, m, p)
    sr, si = xr, xi
    for st in plan.steps:
        if st.kind == "mat":
            sr, si = _contract(sr, si, *mats[st.idx], st.axis)
        else:
            c, s = phases[st.idx]
            sr, si = sr * c - si * s, sr * s + si * c
    return sr, si


def block_chain_bwd_ref(yr, yi, gr, gi, mct, p, plan: KPlan):
    """Plain version of the backward kernel: reverse sweep from the final
    state y with output cotangent g. ``mct`` is the packed conj(M)^T
    (:func:`conj_transpose`). Returns (gxr, gxi, gm, gp): the input
    cotangent and the packed cotangents of the forward's m (M[in, out]
    orientation) and p."""
    LAUNCHES["block_chain_bwd_ref"] += 1
    matcts, phases = unpack(plan, mct, p)
    sr, si, qr, qi = yr, yi, gr, gi
    gmats: List = [None] * plan.n_mats
    gphases: List = [None] * plan.n_diags
    for st in reversed(plan.steps):
        if st.kind == "mat":
            mtr, mti = matcts[st.idx]
            sr, si = _contract(sr, si, mtr, mti, st.axis)  # input recovery
            # dM[k, m] = sum over batch and the other axis of conj(s_in) g
            eq = "bkl,bml->km" if st.axis == "hi" else "bhk,bhm->km"
            dr = torch.einsum(eq, sr, qr) + torch.einsum(eq, si, qi)
            di = torch.einsum(eq, sr, qi) - torch.einsum(eq, si, qr)
            gmats[st.idx] = (dr, di)
            qr, qi = _contract(qr, qi, mtr, mti, st.axis)
        else:
            c, s = phases[st.idx]
            sr, si = c * sr + s * si, c * si - s * sr
            gphases[st.idx] = (
                torch.sum(qr * sr + qi * si, dim=0),
                torch.sum(-qr * si + qi * sr, dim=0),
            )
            qr, qi = c * qr + s * qi, c * qi - s * qr
    return qr, qi, _pack(gmats), _pack(gphases)


def block_chain_reduce_ref(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the slab reduction: [G, slab] -> [slab], summed in
    the kernel's order (slab 0 first)."""
    LAUNCHES["block_chain_reduce_ref"] += 1
    out = partials[0].clone()
    for c in range(1, partials.shape[0]):
        out += partials[c]
    return out


# -- the CUDA library ----------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("block_chain")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qc_block_chain_fwd.argtypes = [p] * 6 + [i, i, i, p, i, p]
        lib.qc_block_chain_bwd.argtypes = [p] * 9 + [i] * 5 + [p, i, i, p]
        lib.qc_block_chain_reduce.argtypes = [p, p, i, i, p]
        for fn in (lib.qc_block_chain_fwd, lib.qc_block_chain_bwd,
                   lib.qc_block_chain_reduce):
            fn.restype = i
        lib.qc_error_string.argtypes = [i]
        lib.qc_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.qc_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _step_table(plan: KPlan) -> Tuple[np.ndarray, int]:
    """[n_steps, 3] int32 (kind, axis, float offset into the packed mats or
    phases) and the packed mats' length; built once per plan."""
    mat_off, off = [], 0
    for idx in range(plan.n_mats):
        mat_off.append(off)
        off += 2 * plan.mat_dim(idx) ** 2
    hl = 1 << plan.n
    rows = []
    for st in plan.steps:
        if st.kind == "mat":
            rows.append((0, 0 if st.axis == "hi" else 1, mat_off[st.idx]))
        else:
            rows.append((1, 0, 2 * hl * st.idx))
    return np.ascontiguousarray(rows, dtype=np.int32).reshape(-1, 3), off


def bwd_config(plan: KPlan) -> Tuple[int, int, int]:
    """(samples per tile, Mct buffers, shared bytes) of one backward CTA
    (bwd_config in csrc/block_chain.cu): a tile of 2 samples' state and
    cotangent planes and a double-buffered [K, K] re/im matrix where both
    blocks are at most 64 wide, else (a 128-wide block at 12 qubits) 1
    sample and 1 buffer; either fits a CTA's shared memory."""
    km = 1 << max(plan.hb, plan.lb)
    tile = bufs = 2 if km <= 64 else 1
    return tile, bufs, 4 * (4 * tile * (1 << plan.n) + 2 * bufs * km * km)


def check_plan(plan: KPlan) -> None:
    """Raise unless the CUDA kernels can run ``plan``: one sample's state
    in one CTA (n <= 12, so 256 threads hold 4x4 tiles of [H, L] forward and
    8 warps its 32x16 tiles backward) and both blocks at least 32 wide (the
    backward's tensor-core tiles; the forward takes the same plans, so an
    engine that cannot train is refused when it is built)."""
    if plan.n > MAX_QUBITS:
        raise ValueError(
            f"block_chain kernels take n <= {MAX_QUBITS} (one sample per "
            f"CTA in shared memory); got n = {plan.n}"
        )
    if min(plan.hb, plan.lb) < MIN_BLOCK_BITS:
        raise ValueError(
            f"block_chain kernels need both blocks >= {MIN_BLOCK_BITS} qubits; "
            f"got {plan.hb}/{plan.lb}")
    if len(plan.steps) > MAX_STEPS:
        raise ValueError(f"plan has {len(plan.steps)} steps > {MAX_STEPS}")


def _check_cuda(plan: KPlan, states, m: torch.Tensor, p: torch.Tensor) -> None:
    check_plan(plan)
    shape = (states[0].shape[0], 1 << plan.hb, 1 << plan.lb)
    sizes = (_step_table(plan)[1], 2 * plan.n_diags * (1 << plan.n))
    for t in (*states, m, p):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError("block_chain kernels take CUDA float32 tensors")
        if not t.is_contiguous():
            raise ValueError("block_chain kernels take contiguous tensors")
    for t in states:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {shape}, got {tuple(t.shape)}")
    if (m.numel(), p.numel()) != sizes:
        raise ValueError(f"packed mats/phases: expected {sizes} floats, got "
                         f"{(m.numel(), p.numel())}")


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"block_chain: unsupported device {t.device}")
    return False


def block_chain_fwd(xr, xi, m, p, plan: KPlan):
    """Forward kernel wrapper; same contract as :func:`block_chain_fwd_ref`."""
    if _on_cpu(xr):
        return block_chain_fwd_ref(xr, xi, m, p, plan)
    _check_cuda(plan, (xr, xi), m, p)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    b = xr.shape[0]
    if b == 0:
        return yr, yi
    lib = _lib()
    steps, _ = _step_table(plan)
    err = lib.qc_block_chain_fwd(
        xr.data_ptr(), xi.data_ptr(), m.data_ptr(), p.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), b, 1 << plan.hb, 1 << plan.lb,
        steps.ctypes.data, len(plan.steps),
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(lib, err, "block_chain_fwd")
    LAUNCHES["block_chain_fwd"] += 1
    return yr, yi


def grid_size(device: torch.device, b: int) -> int:
    """Persistent backward grid: one CTA per SM (its shared memory holds a
    tile of samples), never more than the batch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(b, sms))


def block_chain_reduce(partials: torch.Tensor) -> torch.Tensor:
    """Slab-reduction kernel wrapper: [G, slab] -> [slab]."""
    if _on_cpu(partials):
        return block_chain_reduce_ref(partials)
    if partials.dtype != torch.float32 or not partials.is_contiguous():
        raise ValueError("block_chain_reduce takes contiguous float32 partials")
    g, slab = partials.shape
    out = torch.empty(slab, dtype=torch.float32, device=partials.device)
    lib = _lib()
    err = lib.qc_block_chain_reduce(
        partials.data_ptr(), out.data_ptr(), slab, g,
        torch.cuda.current_stream(partials.device).cuda_stream,
    )
    _raise_on(lib, err, "block_chain_reduce")
    LAUNCHES["block_chain_reduce"] += 1
    return out


def block_chain_bwd_partials(yr, yi, gr, gi, mct, p, plan: KPlan):
    """Backward kernel alone (CUDA tensors only): returns (gxr, gxi,
    partials [G, slab]); :func:`block_chain_reduce` finishes the batch
    sums."""
    _check_cuda(plan, (yr, yi, gr, gi), mct, p)
    h, l = 1 << plan.hb, 1 << plan.lb
    b = yr.shape[0]
    if b == 0:
        raise ValueError("block_chain_bwd needs a non-empty batch")
    lib = _lib()
    steps, mats_total = _step_table(plan)
    slab = mats_total + p.numel()
    gxr, gxi = torch.empty_like(yr), torch.empty_like(yi)
    g = grid_size(yr.device, b)
    partials = torch.empty((g, slab), dtype=torch.float32, device=yr.device)
    err = lib.qc_block_chain_bwd(
        yr.data_ptr(), yi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        mct.data_ptr(), p.data_ptr(), gxr.data_ptr(), gxi.data_ptr(),
        partials.data_ptr(), slab, mats_total, b, h, l,
        steps.ctypes.data, len(plan.steps), g,
        torch.cuda.current_stream(yr.device).cuda_stream,
    )
    _raise_on(lib, err, "block_chain_bwd")
    LAUNCHES["block_chain_bwd"] += 1
    return gxr, gxi, partials


def block_chain_bwd(yr, yi, gr, gi, mct, p, plan: KPlan):
    """Backward kernel wrapper (the kernel, then the slab reduction); same
    contract as :func:`block_chain_bwd_ref`."""
    if _on_cpu(yr):
        return block_chain_bwd_ref(yr, yi, gr, gi, mct, p, plan)
    gxr, gxi, partials = block_chain_bwd_partials(yr, yi, gr, gi, mct, p, plan)
    out = block_chain_reduce(partials)
    # the slab is the packed mats' layout followed by the phases'
    return gxr, gxi, out[: mct.numel()], out[mct.numel() :]


# -- autograd boundary ---------------------------------------------------------


class BlockChain(torch.autograd.Function):
    """Split re/im float tensors in and out (no complex at the boundary, so
    torch's and JAX's complex-gradient conventions never meet); ``m`` and
    ``p`` are the packed mats and phases."""

    @staticmethod
    def forward(ctx, plan: KPlan, xr, xi, m, p):
        yr, yi = block_chain_fwd(xr, xi, m, p, plan)
        ctx.plan = plan
        ctx.save_for_backward(yr, yi, m, p)
        return yr, yi

    @staticmethod
    def backward(ctx, gyr, gyi):
        yr, yi, m, p = ctx.saved_tensors
        # conj-transposed matrices: one matrix serves input recovery and
        # cotangent pullback
        gxr, gxi, gm, gp = block_chain_bwd(
            yr, yi, gyr.contiguous(), gyi.contiguous(),
            conj_transpose(ctx.plan, m), p, ctx.plan,
        )
        return None, gxr, gxi, gm, gp


class BlockKernelCircuit(BlockFusedCircuit):
    """Kernel variant of :class:`BlockFusedCircuit` (JAX:
    ``BlockPallasCircuit``): same interface and segment compilation, but
    the raw segment chain runs in one kernel launch per evolve, and its
    backward in one more. Reverse-mode AD only."""

    def __init__(self, circuit: DVCircuit, hi_bits: Optional[int] = None):
        # the plan walks per-segment hi/lo programs: the raw chain
        super().__init__(circuit, hi_bits=hi_bits, merge=False)
        self.plan = build_plan(self.segments, circuit.n, self.hb)

    def kernel_inputs(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kernels' packed small inputs (m, p), differentiable in
        ``params``: the block unitaries' re then im [K, K], and the phases'
        cos then sin [H, L], in plan order (:func:`unpack` reads them)."""
        lp = self._layer_params(params)
        h, l = 1 << self.hb, 1 << self.lb
        mats = []
        for si, axis in self.plan.mat_srcs:
            seg = self.segments[si]
            if axis == "hi":
                u = _block_unitary(self.hb, seg.hi_prog, lp(seg.layer))
            else:
                u = _block_unitary(self.lb, seg.lo_prog, lp(seg.layer))
            mats.append(torch.view_as_real(u).permute(2, 0, 1).reshape(-1))
        phi = torch.stack([
            self.segments[si].run.phases(lp(self.segments[si].layer)).reshape(h, l)
            for si in self.plan.diag_srcs
        ])
        p = torch.stack([torch.cos(phi), torch.sin(phi)], dim=1).reshape(-1)
        return torch.cat(mats), p

    def evolve(self, params, state):
        b = state.shape[0]
        v = torch.view_as_real(state.reshape(b, 1 << self.hb, 1 << self.lb))
        yr, yi = BlockChain.apply(
            self.plan, v[..., 0].contiguous(), v[..., 1].contiguous(),
            *self.kernel_inputs(params),
        )
        out = torch.view_as_complex(torch.stack([yr, yi], dim=-1))
        return out.reshape(b, 1 << self.circuit.n)
