"""Gate-table loop kernels: the whole gate table of one evolve in one launch,
16-qubit capable (port of qcpinn_tpu/ops/pallas_loop.py).

``compile_loop_program`` lowers a circuit's ansatz layers and epilogue into
the same packed ``[S, 8]`` int32 gate table as the JAX package (kind, wire
axis and exponent, bank index, control). ``csrc/gate_loop.cu`` holds two
hand-written CUDA kernels for Hopper (sm_90a) and a reduction pass:

- ``gate_loop_fwd`` replaces ``pallas_loop.py::_forward_kernel``: a
  thread-block cluster per sample walks the table with the sample in its
  CTAs' shared memory (:func:`cluster_plan`: one CTA up to 13 qubits, 2, 4
  and 8 at 14, 15 and 16).
- ``gate_loop_bwd`` replaces ``pallas_loop.py::_backward_kernel``: the
  reverse sweep with inverse gates, O(1) extra state, the state and its
  cotangent in the cluster's shared memory. The ``[K, 8]`` matrix and
  ``[P, 2^n]`` phase cotangents are batch sums: a persistent grid of G
  clusters writes one partial slab per cluster, and ``gate_loop_reduce``
  adds the slabs in a fixed order (no float atomics, deterministic).

Each kernel has a plain PyTorch version beside it (``*_ref``), which runs
for CPU tensors (the tests) and, on the card, only in the tests and
``chip_smoke.py``. For a CUDA tensor a wrapper launches its kernel or
raises. ``LAUNCHES`` counts kernel launches and plain-version calls.

The kernels take the JAX layout: states ``[B, HI, LO]`` split re/im f32
(HI = 2^(n-7), LO = 128; all lanes below 7 qubits), phase planes
``[P, HI, LO]``. That is the flat ``[B, 2^n]`` row with wire 0 the most
significant bit, which is how the CUDA code indexes it: the partner of
amplitude i across bit g is i ^ (1 << g), with g decoded from the table's
(axis, exponent) pair. The JAX batch padding to a tile and its n >= 10
check are TPU tile constraints and are not carried: on the card the
kernels take 1 <= n <= 16.

Parameter gradients flow outside the kernels: autograd chains the matrix
and phase cotangents through :func:`gather_scalar_inputs`. Reverse-mode AD
only, which is what the tangent-stream residuals need.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build, gates, measure
from . import statevector as sv
from .circuit import DVCircuit
from .diag_fusion import DiagRun, bit_matrix

LO_BITS = 7  # the TPU layout's 128 lanes

# table columns
KIND, A_LANE, A_EXP, IDX, HAS_CTRL, B_LANE, B_EXP, _PAD = range(8)
K_MAT, K_DIAG, K_U2Q = 0, 1, 2

MAX_QUBITS = 16  # on the card
# a CTA holds 2^13 amplitudes of a sample: 128 KB of state and cotangent
# backward, so 16 qubits take a cluster of 8 CTAs, the portable maximum
LOCAL_BITS = 13
MAX_STEPS = 768  # GT_MAX_STEPS in csrc/gate_table.cuh
MAX_BANK = 1 << 16  # the step word keeps a 16-bit bank index

LAUNCHES = {
    "gate_loop_fwd": 0,
    "gate_loop_bwd": 0,
    "gate_loop_reduce": 0,
    "gate_loop_fwd_ref": 0,
    "gate_loop_bwd_ref": 0,
    "gate_loop_reduce_ref": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- the gate table (numpy only, as in the JAX package) -------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity
class LoopProgram:
    n: int
    hi: int  # 2^(n - LO_BITS) sublanes (1 when n <= LO_BITS)
    lo: int  # lane count (128, or 2^n when n < LO_BITS)
    table: np.ndarray  # [S, 8] int32
    num_mats: int
    num_phases: int
    u4_bank: np.ndarray  # [U, 32] f32 — 16 complex entries row-major


def _wire_axis_exp(n: int, lo_bits: int, w: int) -> Tuple[int, int]:
    """wire w (0 = MSB) -> (axis_is_lane, shift exponent within the axis)."""
    g = n - 1 - w  # global bit exponent
    if g < lo_bits:
        return 1, g
    return 0, g - lo_bits


def compile_loop_program(circuit: DVCircuit) -> LoopProgram:
    """Lower a (fused) DVCircuit into the packed gate table. Encoding is NOT
    included — the kernel always runs in evolve mode on a caller-prepared
    state."""
    n = circuit.n
    lo_bits = min(n, LO_BITS)
    rows: List[List[int]] = []
    mat_count = 0
    phase_count = 0
    u4s: List[np.ndarray] = []

    def add_mat(wire: int, ctrl: int = -1):
        nonlocal mat_count
        a_lane, a_exp = _wire_axis_exp(n, lo_bits, wire)
        if ctrl >= 0:
            b_lane, b_exp = _wire_axis_exp(n, lo_bits, ctrl)
            rows.append([K_MAT, a_lane, a_exp, mat_count, 1, b_lane, b_exp, 0])
        else:
            rows.append([K_MAT, a_lane, a_exp, mat_count, 0, 0, 0, 0])
        mat_count += 1

    def add_u2q(wa: int, wb: int, u: np.ndarray):
        a_lane, a_exp = _wire_axis_exp(n, lo_bits, wa)
        b_lane, b_exp = _wire_axis_exp(n, lo_bits, wb)
        u4s.append(np.asarray(u, dtype=np.complex64))
        rows.append([K_U2Q, a_lane, a_exp, len(u4s) - 1, 1, b_lane, b_exp, 0])

    def lower(program):
        nonlocal phase_count
        for op in program:
            if isinstance(op, DiagRun):
                rows.append([K_DIAG, 0, 0, phase_count, 0, 0, 0, 0])
                phase_count += 1
            elif op.kind in ("rx", "ry", "rz", "ps", "rot", "h", "x", "y", "z", "u1q"):
                add_mat(op.wires[0])
            elif op.kind in ("crx", "cry", "crz", "cnot"):
                add_mat(op.wires[1], ctrl=op.wires[0])
            elif op.kind == "cz":
                add_u2q(op.wires[0], op.wires[1], gates.CZ)
            elif op.kind == "swap":
                add_u2q(op.wires[0], op.wires[1], gates.SWAP)
            elif op.kind == "u2q":
                add_u2q(op.wires[0], op.wires[1], op.const)
            else:  # pragma: no cover
                raise ValueError(op.kind)

    for _ in range(circuit.layers):
        lower(circuit.program)
    lower(circuit.epilogue)

    bank = np.zeros((max(len(u4s), 1), 32), dtype=np.float32)
    for u_idx, u in enumerate(u4s):
        flat = u.reshape(16)
        bank[u_idx, 0::2] = np.real(flat)
        bank[u_idx, 1::2] = np.imag(flat)
    return LoopProgram(
        n=n,
        hi=1 << (n - lo_bits),
        lo=1 << lo_bits,
        table=np.asarray(rows, dtype=np.int32).reshape(-1, 8),
        num_mats=mat_count,
        num_phases=phase_count,
        u4_bank=bank,
    )


@dataclasses.dataclass(frozen=True)
class Step:
    """One table row with its wires as global bit exponents (g = n-1-w)."""

    kind: int
    ga: int
    idx: int
    ctrl: bool
    gb: int


@functools.lru_cache(maxsize=32)
def steps(lp: LoopProgram) -> Tuple[Step, ...]:
    """Decode the table: a lane exponent is the bit itself, a sublane
    exponent sits above the lo_bits lane bits."""
    lo_bits = lp.lo.bit_length() - 1

    def bit(lane, exp):
        return int(exp) + (0 if lane else lo_bits)

    return tuple(
        Step(int(r[KIND]), bit(r[A_LANE], r[A_EXP]), int(r[IDX]),
             bool(r[HAS_CTRL]), bit(r[B_LANE], r[B_EXP]))
        for r in lp.table
    )


def pack_steps(table: Sequence[Step]) -> np.ndarray:
    """The CUDA table: one uint32 per step, kind[0:2] | ga[2:7] | gb[7:12]
    | ctrl[12] | idx[16:32] (GtTable in csrc/gate_table.cuh). Read-only:
    callers cache it and share it."""
    words = [
        s.kind | (s.ga << 2) | (s.gb << 7) | (int(s.ctrl) << 12) | (s.idx << 16)
        for s in table
    ]
    out = np.ascontiguousarray(words, dtype=np.uint32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=32)
def step_words(lp: LoopProgram) -> np.ndarray:
    return pack_steps(steps(lp))


# -- the kernels' small inputs, from the circuit parameters ----------------------

_PARAM_FNS = {
    "rx": gates.rx, "ry": gates.ry, "rz": gates.rz, "ps": gates.phase_shift,
    "crx": gates.rx, "cry": gates.ry, "crz": gates.rz,
}
_FIXED = {"h": gates.H, "x": gates.X, "y": gates.Y, "z": gates.Z, "cnot": gates.X}


class LoopConstants:
    """Everything :func:`gather_scalar_inputs` needs that does not depend on
    the parameters, on one device, built once: the index of each mat's
    angles, the fixed 2x2s, the order that puts them in table order, each
    fused diagonal run's coefficient planes, and the u4 bank."""

    def __init__(self, circuit: DVCircuit, lp: LoopProgram, device):
        device = torch.device(device)
        ppl = circuit.params_per_layer
        groups: Dict[str, Tuple[List[int], List]] = {}
        fixed: Tuple[List[int], List[np.ndarray]] = ([], [])
        runs: List[Tuple[int, DiagRun]] = []
        pos = 0

        def lower(program, layer):
            nonlocal pos
            for op in program:
                if isinstance(op, DiagRun):
                    runs.append((layer, op))
                    continue
                k = op.kind
                if k in _PARAM_FNS or k == "rot":
                    where, idx = groups.setdefault(k, ([], []))
                    where.append(pos)
                    flat = [layer * ppl + p for p in op.pidx]
                    idx.append(flat if k == "rot" else flat[0])
                elif k in _FIXED or k == "u1q":
                    fixed[0].append(pos)
                    fixed[1].append(_FIXED[k] if k in _FIXED else op.const)
                elif k in ("cz", "swap", "u2q"):
                    continue  # fixed 4x4s live in the u4 bank
                else:  # pragma: no cover
                    raise ValueError(k)
                pos += 1

        for layer in range(circuit.layers):
            lower(circuit.program, layer)
        lower(circuit.epilogue, -1)
        if pos != lp.num_mats:  # pragma: no cover
            raise ValueError("mat count differs from the gate table")

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        order: List[int] = []
        self.param_groups = []
        for k, (where, idx) in groups.items():
            order += where
            self.param_groups.append((k, dev(idx, torch.long)))
        self.fixed = None
        if fixed[0]:
            order += fixed[0]
            self.fixed = dev(np.stack(fixed[1]), torch.complex64)
        self.perm = dev(np.argsort(order), torch.long) if order else None
        self.num_mats = pos

        bits = bit_matrix(circuit.n)
        self.bits_t = dev(bits.T) if runs else None
        self.runs = []
        for layer, run in runs:
            pair = ks = cvec = None
            if run.quad:
                pair = dev(np.stack([bits[:, c] * bits[:, t] for c, t, _ in run.quad]))
                ks = dev([q[2] for q in run.quad], torch.long)
            if run.const_pairs:
                cv = np.zeros(1 << circuit.n, dtype=np.float32)
                for a, t in run.const_pairs:
                    cv += np.pi * bits[:, a] * bits[:, t]
                cvec = dev(cv)
            theta_idx = dev([layer * ppl + p for p in run.pidx], torch.long)
            self.runs.append((theta_idx, dev(run.w1), dev(run.c1), ks, pair, cvec))
        self.u4 = dev(lp.u4_bank)


def gather_scalar_inputs(circuit: DVCircuit, lp: LoopProgram, params,
                         consts: Optional[LoopConstants] = None):
    """Build (mats8 [K, 8] f32, cos [P, HI, LO], sin [P, HI, LO]) from the
    circuit parameters with torch ops, so gradients flow to ``params``.
    Parameters must be shared across the batch (unbatched [num_params]).
    ``consts`` holds the fixed tensors on ``params``' device; without it
    they are built here (the engine caches one per device). Each phase
    plane follows ``DiagRun.phases``' arithmetic."""
    if params.numel() != circuit.layers * circuit.params_per_layer:
        raise ValueError("loop backend needs unbatched circuit parameters")
    if consts is None:
        consts = LoopConstants(circuit, lp, params.device)
    flat = params.reshape(-1)
    parts = []
    for k, idx in consts.param_groups:
        if k == "rot":
            parts.append(gates.rot(flat[idx[:, 0]], flat[idx[:, 1]], flat[idx[:, 2]]))
        else:
            parts.append(_PARAM_FNS[k](flat[idx]))
    if consts.fixed is not None:
        parts.append(consts.fixed)
    if parts:
        m = torch.cat(parts).to(torch.complex64)[consts.perm]  # [K, 2, 2]
        mats8 = torch.view_as_real(m).reshape(consts.num_mats, 8)
    else:
        mats8 = torch.zeros((1, 8), dtype=torch.float32, device=params.device)
    phases = []
    for theta_idx, w1, c1, ks, pair, cvec in consts.runs:
        theta = flat[theta_idx]
        phi = (theta @ w1) @ consts.bits_t
        phi = phi + torch.sum(theta * c1, dim=-1, keepdim=True)
        if pair is not None:
            phi = phi + theta[ks] @ pair
        if cvec is not None:
            phi = phi + cvec
        phases.append(phi)
    if phases:
        phi = torch.stack(phases, dim=0).to(torch.float32)
    else:
        phi = torch.zeros((1, 1 << lp.n), dtype=torch.float32, device=params.device)
    shape3 = (phi.shape[0], lp.hi, lp.lo)
    return mats8, torch.cos(phi).reshape(shape3), torch.sin(phi).reshape(shape3)


# -- plain PyTorch versions ----------------------------------------------------


def _bit_mask(d: int, g: int, device) -> torch.Tensor:
    """[d] bool: bit g of each amplitude index."""
    return ((torch.arange(d, device=device) >> g) & 1).bool()


def _quad_index(n: int, ga: int, gb: int, device) -> List[torch.Tensor]:
    """Amplitude indices of every quad for bits (ga, gb), in (bit_a, bit_b)
    order 00, 01, 10, 11: four [2^n / 4] tensors."""
    q = torch.arange(1 << (n - 2), device=device)
    lo, hi = min(ga, gb), max(ga, gb)
    i = ((q >> lo) << (lo + 1)) | (q & ((1 << lo) - 1))
    i = ((i >> hi) << (hi + 1)) | (i & ((1 << hi) - 1))
    a, b = 1 << ga, 1 << gb
    return [i, i | b, i | a, i | a | b]


def _mat(m, inverse: bool):
    """((re, im) of the four entries, row-major), conj-transposed for the
    inverse."""
    e = [(m[2 * k], m[2 * k + 1]) for k in range(4)]
    if not inverse:
        return e
    return [(e[j][0], -e[j][1]) for j in (0, 2, 1, 3)]


def _cmadd2(a, x, b, z):
    """a x + b z on (re, im) pairs."""
    return (a[0] * x[0] - a[1] * x[1] + b[0] * z[0] - b[1] * z[1],
            a[0] * x[1] + a[1] * x[0] + b[0] * z[1] + b[1] * z[0])


def _apply_mat(sr, si, st: Step, m, inverse=False):
    """2x2 on bit st.ga of [B, D] planes (where the control bit is 1)."""
    b, d = sr.shape
    e = _mat(m, inverse)
    v = [t.view(b, -1, 2, 1 << st.ga) for t in (sr, si)]
    x0 = (v[0][:, :, 0], v[1][:, :, 0])
    x1 = (v[0][:, :, 1], v[1][:, :, 1])
    y0 = _cmadd2(e[0], x0, e[1], x1)
    y1 = _cmadd2(e[2], x0, e[3], x1)
    yr = torch.stack([y0[0], y1[0]], dim=2).reshape(b, d)
    yi = torch.stack([y0[1], y1[1]], dim=2).reshape(b, d)
    if st.ctrl:
        sel = _bit_mask(d, st.gb, sr.device)
        yr, yi = torch.where(sel, yr, sr), torch.where(sel, yi, si)
    return yr, yi


def _apply_u2q(sr, si, n: int, st: Step, u, inverse=False):
    """Fixed 4x4 on bits (st.ga, st.gb); u is one [32] bank row."""
    idx = _quad_index(n, st.ga, st.gb, sr.device)
    xs = [(sr[:, i], si[:, i]) for i in idx]
    outr, outi = sr.clone(), si.clone()
    for r in range(4):
        accr = accii = 0.0
        for c in range(4):
            e = (c * 4 + r) * 2 if inverse else (r * 4 + c) * 2
            ur, ui = u[e], (-u[e + 1] if inverse else u[e + 1])
            accr = accr + ur * xs[c][0] - ui * xs[c][1]
            accii = accii + ur * xs[c][1] + ui * xs[c][0]
        outr[:, idx[r]] = accr
        outi[:, idx[r]] = accii
    return outr, outi


def loop_fwd_ref(xr, xi, mats8, u4, cos, sin, lp: LoopProgram):
    """Plain version of the forward kernel. xr/xi: [B, HI, LO] f32; mats8
    [K, 8]; u4 [U, 32]; cos/sin [P, HI, LO]. Returns (yr, yi)."""
    LAUNCHES["gate_loop_fwd_ref"] += 1
    b, d = xr.shape[0], 1 << lp.n
    sr, si = xr.reshape(b, d), xi.reshape(b, d)
    c, s = cos.reshape(-1, d), sin.reshape(-1, d)
    for st in steps(lp):
        if st.kind == K_MAT:
            sr, si = _apply_mat(sr, si, st, mats8[st.idx])
        elif st.kind == K_DIAG:
            cc, ss = c[st.idx], s[st.idx]
            sr, si = sr * cc - si * ss, sr * ss + si * cc
        else:
            sr, si = _apply_u2q(sr, si, lp.n, st, u4[st.idx])
    return sr.reshape(xr.shape), si.reshape(xi.shape)


def loop_bwd_ref(yr, yi, gr, gi, mats8, u4, cos, sin, lp: LoopProgram):
    """Plain version of the backward kernel: reverse sweep from the final
    state y with output cotangent g. Returns (gxr, gxi, gm [K, 8],
    gcos [P, HI, LO], gsin): the input cotangent and the cotangents of
    mats8, cos and sin, summed over the batch."""
    LAUNCHES["gate_loop_bwd_ref"] += 1
    b, d = yr.shape[0], 1 << lp.n
    sr, si = yr.reshape(b, d), yi.reshape(b, d)
    qr, qi = gr.reshape(b, d), gi.reshape(b, d)
    c, s = cos.reshape(-1, d), sin.reshape(-1, d)
    gm = [torch.zeros(8, dtype=torch.float32, device=yr.device)
          for _ in range(mats8.shape[0])]
    gc = [torch.zeros(d, dtype=torch.float32, device=yr.device)
          for _ in range(c.shape[0])]
    gs = [torch.zeros(d, dtype=torch.float32, device=yr.device)
          for _ in range(c.shape[0])]
    for st in reversed(steps(lp)):
        if st.kind == K_MAT:
            # recover the gate's input with the inverse (unitary) matrix
            sr, si = _apply_mat(sr, si, st, mats8[st.idx], inverse=True)
            sel = (_bit_mask(d, st.gb, yr.device) if st.ctrl
                   else torch.ones(d, dtype=torch.bool, device=yr.device))
            v = [t.view(b, -1, 2, 1 << st.ga) for t in (sr, si, qr * sel, qi * sel)]
            x = [(v[0][:, :, j], v[1][:, :, j]) for j in (0, 1)]
            g = [(v[2][:, :, j], v[3][:, :, j]) for j in (0, 1)]
            # mbar[i][j] = sum over gated pairs of g_i conj(x_j)
            ent = []
            for i_ in (0, 1):
                for j_ in (0, 1):
                    ent.append(torch.sum(g[i_][0] * x[j_][0] + g[i_][1] * x[j_][1]))
                    ent.append(torch.sum(g[i_][1] * x[j_][0] - g[i_][0] * x[j_][1]))
            gm[st.idx] = gm[st.idx] + torch.stack(ent)
            qr, qi = _apply_mat(qr, qi, st, mats8[st.idx], inverse=True)
        elif st.kind == K_DIAG:
            cc, ss = c[st.idx], s[st.idx]
            sr, si = cc * sr + ss * si, cc * si - ss * sr
            gc[st.idx] = gc[st.idx] + torch.sum(qr * sr + qi * si, dim=0)
            gs[st.idx] = gs[st.idx] + torch.sum(-qr * si + qi * sr, dim=0)
            qr, qi = cc * qr + ss * qi, cc * qi - ss * qr
        else:
            sr, si = _apply_u2q(sr, si, lp.n, st, u4[st.idx], inverse=True)
            qr, qi = _apply_u2q(qr, qi, lp.n, st, u4[st.idx], inverse=True)
    return (qr.reshape(yr.shape), qi.reshape(yi.shape), torch.stack(gm),
            torch.stack(gc).reshape(cos.shape), torch.stack(gs).reshape(sin.shape))


def slab_sum(partials: torch.Tensor) -> torch.Tensor:
    """[G, slab] -> [slab], summed in the reduction kernels' order (slab 0
    first)."""
    out = partials[0].clone()
    for k in range(1, partials.shape[0]):
        out += partials[k]
    return out


def gate_loop_reduce_ref(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the slab reduction: [G, slab] -> [slab]."""
    LAUNCHES["gate_loop_reduce_ref"] += 1
    return slab_sum(partials)


# -- the CUDA library ----------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("gate_loop")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qc_gate_loop_fwd.argtypes = [p] * 8 + [i, i, i, p, i, i, p]
        lib.qc_gate_loop_bwd.argtypes = [p] * 11 + [i] * 6 + [p, i, i, p]
        lib.qc_gate_loop_reduce.argtypes = [p, p, i, i, p]
        lib.qc_gate_loop_max_clusters.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        for fn in (lib.qc_gate_loop_fwd, lib.qc_gate_loop_bwd,
                   lib.qc_gate_loop_reduce, lib.qc_gate_loop_max_clusters):
            fn.restype = i
        lib.qc_gate_loop_error_string.argtypes = [i]
        lib.qc_gate_loop_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.qc_gate_loop_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How the kernels split one sample: a cluster of ``cluster`` CTAs, each
    holding amplitudes [r 2^local_bits, (r + 1) 2^local_bits) in shared
    memory, with ``fwd_smem`` / ``bwd_smem`` bytes of it per CTA."""

    local_bits: int
    cluster: int
    fwd_smem: int
    bwd_smem: int


def cluster_plan(n: int, num_mats: int = MAX_STEPS) -> ClusterPlan:
    """The partition of an n-qubit sample (csrc/gate_loop.cu): the forward
    holds the slice's state, the backward its state and cotangent and the
    CTA's [K, 8] matrix sums (K = ``num_mats``, at most a table's length)."""
    if not 1 <= n <= MAX_QUBITS:
        raise ValueError(f"gate_loop kernels take 1 <= n <= {MAX_QUBITS}; got n = {n}")
    lb = min(n, LOCAL_BITS)
    d = 1 << lb
    return ClusterPlan(lb, 1 << (n - lb), 4 * 2 * d, 4 * (4 * d + 8 * max(num_mats, 1)))


def check_program(lp: LoopProgram) -> None:
    """Raise unless the CUDA kernels can run ``lp``."""
    cluster_plan(lp.n)
    if lp.table.shape[0] > MAX_STEPS:
        raise ValueError(f"gate table has {lp.table.shape[0]} steps > {MAX_STEPS}")
    if max(lp.num_mats, lp.num_phases, lp.u4_bank.shape[0]) > MAX_BANK:
        raise ValueError(f"gate table bank index above {MAX_BANK}")


def _check_cuda(lp: LoopProgram, states, mats8, u4, cos, sin) -> None:
    check_program(lp)
    for t in (*states, mats8, u4, cos, sin):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError("gate_loop kernels take CUDA float32 tensors")
        if not t.is_contiguous():
            raise ValueError("gate_loop kernels take contiguous tensors")
    shape = (states[0].shape[0], lp.hi, lp.lo)
    for t in states:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {shape}, got {tuple(t.shape)}")
    want = {
        "mats8": (mats8, (max(lp.num_mats, 1), 8)),
        "u4": (u4, tuple(lp.u4_bank.shape)),
        "cos": (cos, (max(lp.num_phases, 1), lp.hi, lp.lo)),
        "sin": (sin, (max(lp.num_phases, 1), lp.hi, lp.lo)),
    }
    for name, (t, shp) in want.items():
        if tuple(t.shape) != shp:
            raise ValueError(f"{name}: expected {shp}, got {tuple(t.shape)}")


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"gate_loop: unsupported device {t.device}")
    return False


def gate_loop_fwd(xr, xi, mats8, u4, cos, sin, lp: LoopProgram):
    """Forward kernel wrapper; same contract as :func:`loop_fwd_ref`."""
    if _on_cpu(xr):
        return loop_fwd_ref(xr, xi, mats8, u4, cos, sin, lp)
    _check_cuda(lp, (xr, xi), mats8, u4, cos, sin)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    b = xr.shape[0]
    if b == 0:
        return yr, yi
    lib = _lib()
    words = step_words(lp)
    plan = cluster_plan(lp.n)
    err = lib.qc_gate_loop_fwd(
        xr.data_ptr(), xi.data_ptr(), mats8.data_ptr(), u4.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), yr.data_ptr(), yi.data_ptr(), b, lp.n,
        plan.local_bits, words.ctypes.data, len(words),
        grid_size(max_clusters(xr.device, lp, bwd=False), b),
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(lib, err, "gate_loop_fwd")
    LAUNCHES["gate_loop_fwd"] += 1
    return yr, yi


_MAX_CLUSTERS: Dict[Tuple[int, bool, int, int], int] = {}


def max_clusters(device: torch.device, lp: LoopProgram, bwd: bool) -> int:
    """The most clusters of the forward or backward kernel that ``device``
    holds at once (cudaOccupancyMaxActiveClusters), asked once per device
    and shape. Raises where not one fits."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    plan = cluster_plan(lp.n, lp.num_mats)
    key = (index, bwd, lp.n, plan.bwd_smem)
    if key not in _MAX_CLUSTERS:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.qc_gate_loop_max_clusters(
                int(bwd), lp.n, plan.local_bits, 8 * max(lp.num_mats, 1),
                ctypes.byref(out))
        _raise_on(lib, err, "cudaOccupancyMaxActiveClusters")
        if out.value < 1:
            raise RuntimeError(
                f"no cluster of {plan.cluster} CTAs with "
                f"{plan.bwd_smem if bwd else plan.fwd_smem} bytes of shared "
                "memory each fits on the card")
        _MAX_CLUSTERS[key] = out.value
    return _MAX_CLUSTERS[key]


def grid_size(clusters: int, b: int) -> int:
    """Persistent grid, in clusters: as many as the card holds at once,
    never more than the batch."""
    return max(1, min(b, clusters))


def launch_plan(device: torch.device, lp: LoopProgram, b: int) -> Dict[str, int]:
    """The kernels' launch shape for a batch of ``b`` (for reports)."""
    plan = cluster_plan(lp.n, lp.num_mats)
    return {"local_bits": plan.local_bits, "cluster": plan.cluster,
            "fwd_smem": plan.fwd_smem, "bwd_smem": plan.bwd_smem,
            "fwd_grid": grid_size(max_clusters(device, lp, bwd=False), b),
            "bwd_grid": grid_size(max_clusters(device, lp, bwd=True), b)}


def gate_loop_reduce(partials: torch.Tensor) -> torch.Tensor:
    """Slab-reduction kernel wrapper: [G, slab] -> [slab]."""
    if _on_cpu(partials):
        return gate_loop_reduce_ref(partials)
    if partials.dtype != torch.float32 or not partials.is_contiguous():
        raise ValueError("gate_loop_reduce takes contiguous float32 partials")
    g, slab = partials.shape
    out = torch.empty(slab, dtype=torch.float32, device=partials.device)
    lib = _lib()
    err = lib.qc_gate_loop_reduce(
        partials.data_ptr(), out.data_ptr(), slab, g,
        torch.cuda.current_stream(partials.device).cuda_stream,
    )
    _raise_on(lib, err, "gate_loop_reduce")
    LAUNCHES["gate_loop_reduce"] += 1
    return out


def gate_loop_bwd_partials(yr, yi, gr, gi, mats8, u4, cos, sin, lp: LoopProgram):
    """Backward kernel alone (CUDA tensors only): returns (gxr, gxi,
    partials [G, slab]), one slab per cluster; :func:`gate_loop_reduce`
    finishes the batch sums. A slab is mats8's layout, then cos's, then
    sin's."""
    _check_cuda(lp, (yr, yi, gr, gi), mats8, u4, cos, sin)
    b = yr.shape[0]
    if b == 0:
        raise ValueError("gate_loop_bwd needs a non-empty batch")
    lib = _lib()
    words = step_words(lp)
    g = grid_size(max_clusters(yr.device, lp, bwd=True), b)
    slab = mats8.numel() + cos.numel() + sin.numel()
    gxr, gxi = torch.empty_like(yr), torch.empty_like(yi)
    partials = torch.empty((g, slab), dtype=torch.float32, device=yr.device)
    err = lib.qc_gate_loop_bwd(
        yr.data_ptr(), yi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        mats8.data_ptr(), u4.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        gxr.data_ptr(), gxi.data_ptr(), partials.data_ptr(),
        slab, mats8.numel(), cos.numel(), b, lp.n, cluster_plan(lp.n).local_bits,
        words.ctypes.data, len(words), g,
        torch.cuda.current_stream(yr.device).cuda_stream,
    )
    _raise_on(lib, err, "gate_loop_bwd")
    LAUNCHES["gate_loop_bwd"] += 1
    return gxr, gxi, partials


def gate_loop_bwd(yr, yi, gr, gi, mats8, u4, cos, sin, lp: LoopProgram):
    """Backward kernel wrapper (the kernel, then the slab reduction); same
    contract as :func:`loop_bwd_ref`."""
    if _on_cpu(yr):
        return loop_bwd_ref(yr, yi, gr, gi, mats8, u4, cos, sin, lp)
    gxr, gxi, partials = gate_loop_bwd_partials(
        yr, yi, gr, gi, mats8, u4, cos, sin, lp)
    out = gate_loop_reduce(partials)
    km, kp = mats8.numel(), cos.numel()
    return (gxr, gxi, out[:km].view(mats8.shape),
            out[km : km + kp].view(cos.shape), out[km + kp :].view(sin.shape))


# -- autograd boundary ---------------------------------------------------------


class LoopChain(torch.autograd.Function):
    """Split re/im float tensors in and out (no complex at the boundary, so
    torch's and JAX's complex-gradient conventions never meet); the custom
    VJP of ``pallas_loop.make_loop_state_fn``. ``u4`` is a constant."""

    @staticmethod
    def forward(ctx, lp: LoopProgram, xr, xi, mats8, u4, cos, sin):
        yr, yi = gate_loop_fwd(xr, xi, mats8, u4, cos, sin, lp)
        ctx.lp = lp
        ctx.save_for_backward(yr, yi, mats8, u4, cos, sin)
        return yr, yi

    @staticmethod
    def backward(ctx, gyr, gyi):
        yr, yi, mats8, u4, cos, sin = ctx.saved_tensors
        gxr, gxi, gm, gcos, gsin = gate_loop_bwd(
            yr, yi, gyr.contiguous(), gyi.contiguous(), mats8, u4, cos, sin,
            ctx.lp)
        return None, gxr, gxi, gm, None, gcos, gsin


class LoopFusedCircuit:
    """Gate-table exact-expectation circuit: [B, n] -> [B, n] (JAX:
    ``pallas_loop.LoopFusedCircuit``). First-order reverse AD through params
    and inputs; composes with the tangent-stream residuals through
    :meth:`evolve`. One forward and one backward launch per evolve."""

    def __init__(self, circuit: DVCircuit):
        self.circuit = circuit
        self.lp = compile_loop_program(circuit)
        self._consts: Dict[torch.device, LoopConstants] = {}

    def constants(self, device) -> LoopConstants:
        """The fixed kernel inputs on ``device``, built once per device."""
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = LoopConstants(self.circuit, self.lp, device)
        return self._consts[device]

    def _run(self, params, state_c):
        """Complex [B, 2^n] -> evolved complex [B, 2^n] via the kernels."""
        b = state_c.shape[0]
        lp = self.lp
        consts = self.constants(state_c.device)
        mats8, cos, sin = gather_scalar_inputs(self.circuit, lp, params, consts)
        v = torch.view_as_real(state_c.to(torch.complex64)).reshape(b, lp.hi, lp.lo, 2)
        yr, yi = LoopChain.apply(
            lp, v[..., 0].contiguous(), v[..., 1].contiguous(), mats8,
            consts.u4, cos, sin,
        )
        return torch.complex(yr, yi).reshape(b, 1 << lp.n)

    def evolve(self, params, state):
        """Ansatz layers + epilogue on an arbitrary [B, 2^n] complex state —
        drop-in for DVCircuit.evolve (first-order reverse only)."""
        return self._run(params, state)

    def state(self, params, x):
        if self.circuit.encoding == "amplitude":
            prepared = sv.encode_amplitude(x, self.circuit.n)
        else:
            prepared = sv.encode_angle_product(
                x * self.circuit.input_scale, self.circuit.n
            )
        return self._run(params, prepared)

    def apply(self, params, x, *, shots=None, key=None, noise=None):
        """``[B, F] -> [B, n]`` ``<Z_w>``, with the readout modes of
        ``DVCircuit.apply``."""
        measure.check_key(shots, key)
        if noise is not None:
            noise = noise.bind(self.circuit)
        z = sv.z_expvals(self.state(params, x), self.circuit.n)
        return measure.read_z(z, shots=shots, key=key, noise=noise)

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)
