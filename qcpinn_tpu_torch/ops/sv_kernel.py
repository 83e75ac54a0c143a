"""Unrolled micro-program kernels: the whole gate program of one apply or
evolve in one launch, 1 <= n <= 12 (port of qcpinn_tpu/ops/pallas_sv.py).

``compile_circuit`` lowers a circuit into the JAX package's micro-program:
steps ``1q`` (a per-sample 2x2 from the ``[B, K, 2, 2]`` matrix bank),
``c1q`` (the same, only where the control bit is 1), ``diag`` (multiply by
the phase row ``(cos + i sin)[p]``) and ``u2q`` (a fixed 4x4 on two
wires). With the encoding, the bank's first ``n`` matrices are the
per-sample RX gates and the state starts at ``|0...0>``.
``csrc/unrolled_sv.cu`` holds two hand-written CUDA kernels for Hopper
(sm_90a) and a reduction pass:

- ``unrolled_fwd`` replaces ``pallas_sv.py::_forward_kernel``: one CTA per
  sample keeps its ``2^n`` split re/im amplitudes in shared memory for the
  whole program; the partner across wire w is ``i ^ (1 << (n-1-w))``.
- ``unrolled_bwd`` replaces ``pallas_sv.py::_backward_kernel``: the reverse
  sweep with inverse gates, O(1) extra state. It writes the per-sample
  matrix cotangent ``[B, K, 2, 2]`` and the input cotangent; the
  ``[P, 2^n]`` phase cotangents are batch sums, written into one slab per
  CTA of a persistent grid, and ``unrolled_reduce`` adds the slabs in a
  fixed order (no float atomics, deterministic). Two routes, picked by n
  (:func:`unrolled_bwd_partials`): at n <= 9 ``unrolled_bwd_warp`` holds a
  sample in one warp's registers (no barrier in the sweep; the phase
  cotangents stay in registers over the warp's samples); at 10 <= n <= 12
  ``unrolled_bwd_cta`` holds it in a CTA's shared memory, one thread per
  amplitude pair and a barrier a step.

The program reaches the kernels as a step table passed by value in the
kernel parameters, so nothing is compiled per circuit: Mosaic's per-circuit
compile cost (``pallas_sv.py:397-410``) has no counterpart. The JAX batch
padding to a tile and its n >= 7 lane check are TPU tile constraints and
are not carried.

Each kernel has a plain PyTorch version beside it (``*_ref``), which runs
for CPU tensors (the tests) and, on the card, only in the tests and
``chip_smoke.py``. For a CUDA tensor a wrapper launches its kernel or
raises. ``LAUNCHES`` counts kernel launches and plain-version calls.

Parameter and input gradients flow outside the kernels: autograd chains
the matrix and phase cotangents through :func:`gather_inputs`.
Reverse-mode AD only, which is what the tangent-stream residuals need.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import cuda_build, gates
from . import loop_kernel as lk
from .block_kernel import SMEM_MAX
from . import statevector as sv
from .circuit import DVCircuit
from .diag_fusion import DiagRun

MAX_QUBITS = 12  # one sample and its cotangent fit in a CTA's shared memory
MAX_STEPS = lk.MAX_STEPS  # GT_MAX_STEPS in csrc/gate_table.cuh
MAX_BANK = lk.MAX_BANK  # the step word keeps a 16-bit bank index
MAX_THREADS = 512  # GT_MAX_THREADS
WARP_MAX_QUBITS = 9  # UW_MAX_QUBITS: the warp route's sample fits in registers
WARPS = 8  # UW_MAX_WARPS, warps a CTA of the warp route

LAUNCHES = {
    "unrolled_fwd": 0,
    "unrolled_bwd": 0,
    "unrolled_bwd_warp": 0,
    "unrolled_reduce": 0,
    "unrolled_fwd_ref": 0,
    "unrolled_bwd_ref": 0,
    "unrolled_reduce_ref": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- the micro-program (numpy only, as in the JAX package) ----------------------


@dataclasses.dataclass(frozen=True)
class Step:
    kind: str  # '1q' | 'c1q' | 'diag' | 'u2q'
    wire: int = -1
    ctrl: int = -1
    mat: int = -1  # index into the batched 1q matrix bank
    phase: int = -1  # index into the (cos, sin) phase bank
    u4: int = -1  # index into the fixed 4x4 bank


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity
class MicroProgram:
    n: int
    steps: Tuple[Step, ...]
    num_mats: int
    num_phases: int
    u4s: Tuple[np.ndarray, ...]  # fixed (non-trainable) 4x4 unitaries


def compile_circuit(circuit: DVCircuit, include_encoding: bool = True) -> MicroProgram:
    """Lower a (fused) DVCircuit into a micro-program. With encoding, the
    matrix bank layout is [0, n) = encoding RX gates, then ansatz/epilogue
    1q + c1q gates in program order, repeated per layer. Without encoding
    the program acts on an arbitrary caller-supplied initial state (the
    tangent-stream path)."""
    if include_encoding and circuit.encoding != "angle":
        raise ValueError("the unrolled encoding program takes angle encoding")
    n = circuit.n
    if include_encoding:
        steps: List[Step] = [Step("1q", wire=w, mat=w) for w in range(n)]
        mat_count = n
    else:
        steps = []
        mat_count = 0
    phase_count = 0
    u4s: List[np.ndarray] = []

    def lower(program):
        nonlocal mat_count, phase_count
        for op in program:
            if isinstance(op, DiagRun):
                steps.append(Step("diag", phase=phase_count))
                phase_count += 1
            elif op.kind in ("rx", "ry", "rz", "ps", "rot", "h", "x", "y", "z", "u1q"):
                steps.append(Step("1q", wire=op.wires[0], mat=mat_count))
                mat_count += 1
            elif op.kind in ("crx", "cry", "crz", "cnot"):
                steps.append(
                    Step("c1q", ctrl=op.wires[0], wire=op.wires[1], mat=mat_count)
                )
                mat_count += 1
            elif op.kind in ("cz", "swap", "u2q"):
                if op.kind == "u2q":
                    u4s.append(np.asarray(op.const, dtype=np.complex64))
                elif op.kind == "cz":
                    u4s.append(gates.CZ)
                else:
                    u4s.append(gates.SWAP)
                steps.append(
                    Step("u2q", ctrl=op.wires[0], wire=op.wires[1], u4=len(u4s) - 1)
                )
            else:  # pragma: no cover
                raise ValueError(op.kind)

    for _ in range(circuit.layers):
        lower(circuit.program)
    lower(circuit.epilogue)
    return MicroProgram(n, tuple(steps), mat_count, phase_count, tuple(u4s))


@functools.lru_cache(maxsize=64)
def steps(mp: MicroProgram) -> Tuple[lk.Step, ...]:
    """The program as gate-table steps, wires as bit exponents g = n-1-w:
    a 1q/c1q step is a mat on bit ga (control bit gb), a u2q step acts on
    (ga, gb) = (ctrl, wire) in the (bit_a, bit_b) index order of
    ``u.reshape(2, 2, 2, 2)``."""
    n = mp.n
    out = []
    for s in mp.steps:
        if s.kind == "1q":
            out.append(lk.Step(lk.K_MAT, n - 1 - s.wire, s.mat, False, 0))
        elif s.kind == "c1q":
            out.append(lk.Step(lk.K_MAT, n - 1 - s.wire, s.mat, True, n - 1 - s.ctrl))
        elif s.kind == "diag":
            out.append(lk.Step(lk.K_DIAG, 0, s.phase, False, 0))
        else:
            out.append(lk.Step(lk.K_U2Q, n - 1 - s.ctrl, s.u4, True, n - 1 - s.wire))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def step_words(mp: MicroProgram) -> np.ndarray:
    """The CUDA table (``lk.pack_steps``), cached per program."""
    return lk.pack_steps(steps(mp))


# -- the kernels' inputs, from the circuit parameters and the encoding inputs ----


class SvConstants:
    """Everything :func:`gather_inputs` and the engine need that does not
    depend on the parameters, on one device, built once: the gate-loop
    constants (angle indices, fixed 2x2s, phase-plane coefficients and the
    u4 bank; the gate table lowers the ansatz and epilogue in the
    micro-program's order), the zero phase row that stands in for an empty
    phase bank, the one-row ``|0...0>`` state, the identity 2x2 of a
    program with no matrix, and the ``<Z>`` sign matrix."""

    def __init__(self, circuit: DVCircuit, device):
        device = torch.device(device)
        d = 1 << circuit.n
        self.lp = lk.compile_loop_program(circuit)
        self.loop = lk.LoopConstants(circuit, self.lp, device)
        self.u4 = self.loop.u4
        self.zero_phase = torch.zeros((1, d), dtype=torch.float32, device=device)
        self.no_phase = torch.zeros((0, d), dtype=torch.float32, device=device)
        e0 = torch.zeros((1, d), dtype=torch.float32)
        e0[0, 0] = 1.0
        self.e0 = e0.to(device)
        self.eye = torch.eye(2, dtype=torch.float32, device=device)[None, None]
        self.sign = sv.z_sign(circuit.n, device)


def gather_inputs(circuit: DVCircuit, mp: MicroProgram, params, x,
                  batch: Optional[int] = None,
                  consts: Optional[SvConstants] = None):
    """Build (mats re, mats im [B, K, 2, 2], cos, sin [P, 2^n]) from the
    circuit parameters and (optionally) the encoding inputs, with torch ops
    so gradients flow to ``params`` and ``x``. ``x=None`` builds the
    no-encoding bank (pass ``batch``). The shared ansatz gates are
    broadcast over the batch; a program with no matrix gets one identity,
    and one with no phase run an empty ``[0, 2^n]`` bank, as in JAX.
    ``consts`` holds the fixed tensors on ``params``' device; without it
    they are built here (the engine caches one per device)."""
    b = x.shape[0] if x is not None else batch
    if consts is None:
        consts = SvConstants(circuit, params.device)
    mats8, cos, sin = lk.gather_scalar_inputs(circuit, consts.lp, params, consts.loop)
    re: List[torch.Tensor] = []
    im: List[torch.Tensor] = []
    if x is not None:
        enc = gates.rx(x[:, : circuit.n] * circuit.input_scale)  # [B, n, 2, 2]
        re.append(enc.real)
        im.append(enc.imag)
    if consts.lp.num_mats:
        m = mats8.view(-1, 2, 2, 2)  # [K, i, j, (re, im)]
        re.append(m[..., 0].expand(b, -1, -1, -1))
        im.append(m[..., 1].expand(b, -1, -1, -1))
    if not re:  # pure-diagonal program: one identity for the bank's shape
        re.append(consts.eye.expand(b, 1, 2, 2))
        im.append(torch.zeros_like(consts.eye).expand(b, 1, 2, 2))
    mre, mim = torch.cat(re, dim=1), torch.cat(im, dim=1)
    if mp.num_phases == 0:
        return mre, mim, consts.no_phase, consts.no_phase
    d = 1 << circuit.n
    return mre, mim, cos.reshape(-1, d), sin.reshape(-1, d)


# -- plain PyTorch versions ----------------------------------------------------


def _sample_mat(mre, mim, k: int) -> torch.Tensor:
    """Matrix k of every sample as lk's eight (re, im) entries, row-major,
    each a [B, 1, 1] column: [8, B, 1, 1]."""
    e = torch.stack([mre[:, k], mim[:, k]], dim=-1).reshape(-1, 8)
    return e.T.reshape(8, -1, 1, 1)


def unrolled_fwd_ref(xr, xi, mre, mim, cos, sin, u4, mp: MicroProgram):
    """Plain version of the forward kernel. xr/xi: [B, 2^n] f32; mre/mim
    [B, K, 2, 2]; cos/sin [P, 2^n]; u4 [U, 32]. Returns (yr, yi)."""
    LAUNCHES["unrolled_fwd_ref"] += 1
    sr, si = xr, xi
    for st in steps(mp):
        if st.kind == lk.K_MAT:
            sr, si = lk._apply_mat(sr, si, st, _sample_mat(mre, mim, st.idx))
        elif st.kind == lk.K_DIAG:
            c, s = cos[st.idx], sin[st.idx]
            sr, si = sr * c - si * s, sr * s + si * c
        else:
            sr, si = lk._apply_u2q(sr, si, mp.n, st, u4[st.idx])
    return sr, si


def unrolled_bwd_ref(yr, yi, gr, gi, mre, mim, cos, sin, u4, mp: MicroProgram):
    """Plain version of the backward kernel: reverse sweep from the final
    state y with output cotangent g. Returns (gxr, gxi, gmre, gmim
    [B, K, 2, 2], gcos, gsin [P, 2^n]): the input cotangent, the
    per-sample matrix cotangents, and the phase cotangents summed over the
    batch."""
    LAUNCHES["unrolled_bwd_ref"] += 1
    b, d = yr.shape
    sr, si, qr, qi = yr, yi, gr, gi
    gm = [torch.zeros(b, 8, dtype=torch.float32, device=yr.device)
          for _ in range(mre.shape[1])]
    gc = [torch.zeros(d, dtype=torch.float32, device=yr.device)
          for _ in range(cos.shape[0])]
    gs = [torch.zeros(d, dtype=torch.float32, device=yr.device)
          for _ in range(cos.shape[0])]
    for st in reversed(steps(mp)):
        if st.kind == lk.K_MAT:
            m = _sample_mat(mre, mim, st.idx)
            # recover the gate's input with the inverse (unitary) matrix
            sr, si = lk._apply_mat(sr, si, st, m, inverse=True)
            sel = (lk._bit_mask(d, st.gb, yr.device) if st.ctrl
                   else torch.ones(d, dtype=torch.bool, device=yr.device))
            v = [t.view(b, -1, 2, 1 << st.ga) for t in (sr, si, qr * sel, qi * sel)]
            x = [(v[0][:, :, j], v[1][:, :, j]) for j in (0, 1)]
            g = [(v[2][:, :, j], v[3][:, :, j]) for j in (0, 1)]
            # mbar[i][j] = sum over the sample's gated pairs of g_i conj(x_j)
            ent = []
            for i_ in (0, 1):
                for j_ in (0, 1):
                    ent.append(torch.sum(g[i_][0] * x[j_][0] + g[i_][1] * x[j_][1],
                                         dim=(1, 2)))
                    ent.append(torch.sum(g[i_][1] * x[j_][0] - g[i_][0] * x[j_][1],
                                         dim=(1, 2)))
            gm[st.idx] = gm[st.idx] + torch.stack(ent, dim=1)
            qr, qi = lk._apply_mat(qr, qi, st, m, inverse=True)
        elif st.kind == lk.K_DIAG:
            c, s = cos[st.idx], sin[st.idx]
            sr, si = c * sr + s * si, c * si - s * sr
            gc[st.idx] = gc[st.idx] + torch.sum(qr * sr + qi * si, dim=0)
            gs[st.idx] = gs[st.idx] + torch.sum(-qr * si + qi * sr, dim=0)
            qr, qi = c * qr + s * qi, c * qi - s * qr
        else:
            sr, si = lk._apply_u2q(sr, si, mp.n, st, u4[st.idx], inverse=True)
            qr, qi = lk._apply_u2q(qr, qi, mp.n, st, u4[st.idx], inverse=True)
    g8 = torch.stack(gm, dim=1).view(b, -1, 2, 2, 2)
    return (qr, qi, g8[..., 0].contiguous(), g8[..., 1].contiguous(),
            torch.stack(gc), torch.stack(gs))


def unrolled_reduce_ref(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the slab reduction: [G, slab] -> [slab], summed in
    the kernel's order (slab 0 first)."""
    LAUNCHES["unrolled_reduce_ref"] += 1
    return lk.slab_sum(partials)


# -- the CUDA library ----------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("unrolled_sv")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qc_unrolled_fwd.argtypes = [p] * 9 + [i] * 4 + [p, i, p]
        lib.qc_unrolled_bwd.argtypes = [p] * 14 + [i] * 5 + [p, i, i, p]
        lib.qc_unrolled_bwd_warp.argtypes = [p] * 14 + [i] * 6 + [p, i, i, p]
        lib.qc_unrolled_bwd_warp_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.qc_unrolled_reduce.argtypes = [p, p, i, i, p]
        for fn in (lib.qc_unrolled_fwd, lib.qc_unrolled_bwd, lib.qc_unrolled_bwd_warp,
                   lib.qc_unrolled_bwd_warp_occupancy, lib.qc_unrolled_reduce):
            fn.restype = i
        lib.qc_unrolled_error_string.argtypes = [i]
        lib.qc_unrolled_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.qc_unrolled_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def threads(n: int) -> int:
    """CTA size: one thread per amplitude pair, one warp at least."""
    return min(MAX_THREADS, max(32, 1 << (n - 1)))


def check_program(mp: MicroProgram) -> None:
    """Raise unless the CUDA kernels can run ``mp``."""
    if not 1 <= mp.n <= MAX_QUBITS:
        raise ValueError(
            f"unrolled kernels take 1 <= n <= {MAX_QUBITS}; got n = {mp.n}"
        )
    if len(mp.steps) > MAX_STEPS:
        raise ValueError(f"micro-program has {len(mp.steps)} steps > {MAX_STEPS}")
    if max(mp.num_mats, mp.num_phases, len(mp.u4s)) > MAX_BANK:
        raise ValueError(f"micro-program bank index above {MAX_BANK}")


def _check_cuda(mp: MicroProgram, states, mre, mim, cos, sin, u4) -> None:
    check_program(mp)
    for t in (*states, mre, mim, cos, sin, u4):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError("unrolled kernels take CUDA float32 tensors")
        if not t.is_contiguous():
            raise ValueError("unrolled kernels take contiguous tensors")
    b, d = states[0].shape[0], 1 << mp.n
    for t in states:
        if tuple(t.shape) != (b, d):
            raise ValueError(f"expected {(b, d)}, got {tuple(t.shape)}")
    want = {
        "mre": (mre, (b, max(mp.num_mats, 1), 2, 2)),
        "mim": (mim, (b, max(mp.num_mats, 1), 2, 2)),
        "cos": (cos, (max(mp.num_phases, 1), d)),
        "sin": (sin, (max(mp.num_phases, 1), d)),
        "u4": (u4, (max(len(mp.u4s), 1), 32)),
    }
    for name, (t, shp) in want.items():
        if tuple(t.shape) != shp:
            raise ValueError(f"{name}: expected {shp}, got {tuple(t.shape)}")


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unrolled: unsupported device {t.device}")
    return False


def unrolled_fwd(xr, xi, mre, mim, cos, sin, u4, mp: MicroProgram):
    """Forward kernel wrapper; same contract as :func:`unrolled_fwd_ref`."""
    if _on_cpu(xr):
        return unrolled_fwd_ref(xr, xi, mre, mim, cos, sin, u4, mp)
    _check_cuda(mp, (xr, xi), mre, mim, cos, sin, u4)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    b = xr.shape[0]
    if b == 0:
        return yr, yi
    lib = _lib()
    words = step_words(mp)
    err = lib.qc_unrolled_fwd(
        xr.data_ptr(), xi.data_ptr(), mre.data_ptr(), mim.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), u4.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        b, mp.n, mre.shape[1], threads(mp.n), words.ctypes.data, len(words),
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(lib, err, "unrolled_fwd")
    LAUNCHES["unrolled_fwd"] += 1
    return yr, yi


def grid_size(device: torch.device, b: int, n: int) -> int:
    """The CTA route's persistent grid: up to 2048 threads' worth of CTAs an SM
    (at most 8), never more than the batch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(8, 2048 // threads(n)))
    return max(1, min(b, per_sm * sms))


def unrolled_reduce(partials: torch.Tensor) -> torch.Tensor:
    """Slab-reduction kernel wrapper: [G, slab] -> [slab]."""
    if _on_cpu(partials):
        return unrolled_reduce_ref(partials)
    if partials.dtype != torch.float32 or not partials.is_contiguous():
        raise ValueError("unrolled_reduce takes contiguous float32 partials")
    g, slab = partials.shape
    out = torch.empty(slab, dtype=torch.float32, device=partials.device)
    lib = _lib()
    err = lib.qc_unrolled_reduce(
        partials.data_ptr(), out.data_ptr(), slab, g,
        torch.cuda.current_stream(partials.device).cuda_stream,
    )
    _raise_on(lib, err, "unrolled_reduce")
    LAUNCHES["unrolled_reduce"] += 1
    return out


def warp_smem(n: int, k: int, p: int, u: int) -> Tuple[int, int]:
    """Shared-memory bytes of the warp route: (a warp's, the CTA's own).
    A warp holds the sample's ``[2, K, 2, 2]`` matrix cotangents and
    matrices and its ``[2, P, 2^n]`` phase cotangents; the CTA one copy of
    the ``[2, P, 2^n]`` phase rows and the ``[U, 32]`` 4x4s."""
    pd = p * (1 << n)
    return 4 * (16 * k + 2 * pd), 4 * (2 * pd + 32 * u)


@functools.lru_cache(maxsize=64)
def _warp_blocks(device_index: int, n: int, warps: int, smem: int) -> int:
    """CTAs of the warp route one SM holds at once (the occupancy query)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        lib = _lib()
        _raise_on(lib, lib.qc_unrolled_bwd_warp_occupancy(n, warps, smem,
                                                          ctypes.byref(blocks)),
                  "unrolled_bwd_warp occupancy")
    return blocks.value


def warp_config(device: torch.device, n: int, k: int, p: int, u: int, b: int):
    """(warps a CTA, shared bytes a CTA, grid, CTAs an SM) of the warp
    route. Its registers (about 150 a thread at 8 qubits) cap the warps an
    SM holds, and how many of them fit depends on the CTA size: of 8, 4 and
    2 warps a CTA (as far as SMEM_MAX allows) it takes the size that keeps
    the most warps resident (the occupancy query), the larger on a tie
    (fewer slabs for the slab sum). A persistent grid of as many CTAs as
    the SMs hold at once, never more than the batch needs."""
    per_warp, shared = warp_smem(n, k, p, u)
    fit = (SMEM_MAX - shared) // per_warp
    if fit < 1:
        raise ValueError(f"unrolled_bwd_warp: {per_warp} shared bytes a warp and "
                         f"{shared} a CTA (K = {k}, P = {p}, U = {u}) > {SMEM_MAX}")
    best = None
    for warps in sorted({min(w, fit) for w in (WARPS, 4, 2)}, reverse=True):
        smem = warps * per_warp + shared
        blocks = _warp_blocks(device.index or 0, n, warps, smem)
        if best is None or blocks * warps > best[0] * best[1]:
            best = (blocks, warps, smem)
    blocks, warps, smem = best
    if blocks < 1:
        raise ValueError(f"unrolled_bwd_warp: no CTA of {warps} warps and {smem} "
                         "shared bytes fits an SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return warps, smem, max(1, min(-(-b // warps), blocks * sms)), blocks


def unrolled_bwd_partials(yr, yi, gr, gi, mre, mim, cos, sin, u4, mp: MicroProgram):
    """Backward kernel alone (CUDA tensors only): returns (gxr, gxi, gmre,
    gmim, partials [G, 2 * P * 2^n]); :func:`unrolled_reduce` finishes the
    phase sums. A slab is cos's layout, then sin's. The route by n: the
    warp kernel at n <= WARP_MAX_QUBITS, the CTA kernel above."""
    route = (unrolled_bwd_warp_partials if mp.n <= WARP_MAX_QUBITS
             else unrolled_bwd_cta_partials)
    return route(yr, yi, gr, gi, mre, mim, cos, sin, u4, mp)


def unrolled_bwd_warp_partials(yr, yi, gr, gi, mre, mim, cos, sin, u4,
                               mp: MicroProgram):
    """The warp route of :func:`unrolled_bwd_partials` (1 <= n <= 9): one
    warp a sample, its state and cotangent in registers."""
    _check_cuda(mp, (yr, yi, gr, gi), mre, mim, cos, sin, u4)
    if mp.n > WARP_MAX_QUBITS:
        raise ValueError(f"unrolled_bwd_warp takes n <= {WARP_MAX_QUBITS}; got n = {mp.n}")
    b = yr.shape[0]
    if b == 0:
        raise ValueError("unrolled_bwd needs a non-empty batch")
    lib = _lib()
    words = step_words(mp)
    k, p, u = mre.shape[1], cos.shape[0], u4.shape[0]
    warps, _, g, _ = warp_config(yr.device, mp.n, k, p, u, b)
    gxr, gxi = torch.empty_like(yr), torch.empty_like(yi)
    gmre, gmim = torch.empty_like(mre), torch.empty_like(mim)
    partials = torch.empty((g, 2 * cos.numel()), dtype=torch.float32,
                           device=yr.device)
    err = lib.qc_unrolled_bwd_warp(
        yr.data_ptr(), yi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        mre.data_ptr(), mim.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        u4.data_ptr(), gxr.data_ptr(), gxi.data_ptr(), gmre.data_ptr(),
        gmim.data_ptr(), partials.data_ptr(), b, mp.n, k, p, u, warps,
        words.ctypes.data, len(words), g,
        torch.cuda.current_stream(yr.device).cuda_stream,
    )
    _raise_on(lib, err, "unrolled_bwd_warp")
    LAUNCHES["unrolled_bwd_warp"] += 1
    return gxr, gxi, gmre, gmim, partials


def unrolled_bwd_cta_partials(yr, yi, gr, gi, mre, mim, cos, sin, u4,
                              mp: MicroProgram):
    """The CTA route of :func:`unrolled_bwd_partials` (the route at 10 <= n
    <= 12; it takes any 1 <= n <= 12): one CTA a sample in shared memory."""
    _check_cuda(mp, (yr, yi, gr, gi), mre, mim, cos, sin, u4)
    b = yr.shape[0]
    if b == 0:
        raise ValueError("unrolled_bwd needs a non-empty batch")
    lib = _lib()
    words = step_words(mp)
    g = grid_size(yr.device, b, mp.n)
    gxr, gxi = torch.empty_like(yr), torch.empty_like(yi)
    gmre, gmim = torch.empty_like(mre), torch.empty_like(mim)
    partials = torch.empty((g, 2 * cos.numel()), dtype=torch.float32,
                           device=yr.device)
    err = lib.qc_unrolled_bwd(
        yr.data_ptr(), yi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        mre.data_ptr(), mim.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        u4.data_ptr(), gxr.data_ptr(), gxi.data_ptr(), gmre.data_ptr(),
        gmim.data_ptr(), partials.data_ptr(), b, mp.n, mre.shape[1], cos.shape[0],
        threads(mp.n), words.ctypes.data, len(words), g,
        torch.cuda.current_stream(yr.device).cuda_stream,
    )
    _raise_on(lib, err, "unrolled_bwd")
    LAUNCHES["unrolled_bwd"] += 1
    return gxr, gxi, gmre, gmim, partials


def unrolled_bwd(yr, yi, gr, gi, mre, mim, cos, sin, u4, mp: MicroProgram):
    """Backward kernel wrapper (the kernel, then the slab reduction); same
    contract as :func:`unrolled_bwd_ref`."""
    if _on_cpu(yr):
        return unrolled_bwd_ref(yr, yi, gr, gi, mre, mim, cos, sin, u4, mp)
    gxr, gxi, gmre, gmim, partials = unrolled_bwd_partials(
        yr, yi, gr, gi, mre, mim, cos, sin, u4, mp)
    out = unrolled_reduce(partials)
    kp = cos.numel()
    return (gxr, gxi, gmre, gmim, out[:kp].view(cos.shape),
            out[kp:].view(sin.shape))


# -- autograd boundary ---------------------------------------------------------


class UnrolledChain(torch.autograd.Function):
    """Split re/im float tensors in and out (no complex at the boundary, so
    torch's and JAX's complex-gradient conventions never meet); the custom
    VJP of ``pallas_sv.make_fused_state_fn``. ``u4`` is a constant."""

    @staticmethod
    def forward(ctx, mp: MicroProgram, xr, xi, mre, mim, cos, sin, u4):
        yr, yi = unrolled_fwd(xr, xi, mre, mim, cos, sin, u4, mp)
        ctx.mp = mp
        ctx.save_for_backward(yr, yi, mre, mim, cos, sin, u4)
        return yr, yi

    @staticmethod
    def backward(ctx, gyr, gyi):
        yr, yi, mre, mim, cos, sin, u4 = ctx.saved_tensors
        gxr, gxi, gmre, gmim, gcos, gsin = unrolled_bwd(
            yr, yi, gyr.contiguous(), gyi.contiguous(), mre, mim, cos, sin, u4,
            ctx.mp)
        return None, gxr, gxi, gmre, gmim, gcos, gsin, None


class FusedCircuit:
    """Unrolled exact-expectation circuit: [B, n_features] -> [B, n] (JAX:
    ``pallas_sv.FusedCircuit``). First-order reverse AD through params and
    inputs; composes with the tangent-stream residuals through
    :meth:`evolve`. One forward and one backward launch per apply or
    evolve. Angle encoding runs inside the kernel (the RX bank first);
    amplitude encoding prepares the state with ``encode_amplitude`` and
    runs the evolve-only program, as the tangent streams do."""

    def __init__(self, circuit: DVCircuit):
        self.circuit = circuit
        self._amplitude = circuit.encoding == "amplitude"
        self.mp = None if self._amplitude else compile_circuit(circuit)
        # no-encoding variant for arbitrary initial states (tangent streams)
        self.mp_evolve = compile_circuit(circuit, include_encoding=False)
        self._consts: Dict[torch.device, SvConstants] = {}

    def constants(self, device) -> SvConstants:
        """The fixed kernel inputs on ``device``, built once per device."""
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = SvConstants(self.circuit, device)
        return self._consts[device]

    def _run(self, mp, params, xr, xi, x=None):
        consts = self.constants(xr.device)
        mre, mim, cos, sin = gather_inputs(self.circuit, mp, params, x,
                                           batch=xr.shape[0], consts=consts)
        if mp.num_phases == 0:
            cos = sin = consts.zero_phase
        return UnrolledChain.apply(mp, xr, xi, mre, mim, cos, sin, consts.u4)

    def evolve(self, params, state):
        """Ansatz layers + epilogue on an arbitrary [B, 2^n] complex state —
        drop-in for DVCircuit.evolve (first-order reverse only)."""
        v = torch.view_as_real(state.to(torch.complex64))
        yr, yi = self._run(self.mp_evolve, params, v[..., 0].contiguous(),
                           v[..., 1].contiguous())
        return torch.complex(yr, yi)

    def _planes(self, params, x):
        """The final state's (re, im) planes for inputs x."""
        if self._amplitude:
            st = self.evolve(params, sv.encode_amplitude(x, self.circuit.n))
            return st.real, st.imag
        e0 = self.constants(x.device).e0
        xr = e0.expand(x.shape[0], -1).contiguous()
        return self._run(self.mp, params, xr, torch.zeros_like(xr), x)

    def state(self, params, x):
        return torch.complex(*self._planes(params, x))

    def apply(self, params, x, *, shots=None, key=None, noise=None):
        """``[B, F] -> [B, n]`` exact ``<Z_w>``: probabilities times the
        sign matrix."""
        if shots is not None or noise is not None:
            raise NotImplementedError(
                "shot sampling and noise models are not yet ported "
                "(ROADMAP queue 1 item 9)")
        yr, yi = self._planes(params, x)
        return (yr * yr + yi * yi) @ self.constants(x.device).sign

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)
