"""Block-chain kernels: the whole block-segment chain of one evolve in one
launch (port of qcpinn_tpu/ops/block_pallas.py).

Two kernel pairs, each a forward and a reverse-sweep backward written by
hand in CUDA for Hopper (sm_90a), share one slab reduction:

- ``csrc/block_chain.cu``, the 12-qubit pair, takes 10 <= n <= 12 with both
  blocks 32 to 128 wide (the plans ``auto`` sends to ``block_kernel``).
  ``block_chain_fwd_kernel`` replaces ``block_pallas.py::_forward_kernel``:
  a persistent CTA per SM keeps a tile of samples' split re/im ``[H, L]``
  states in shared memory for the whole chain (:func:`fwd_config`), so the
  state is read and written once; each mat step is one complex product on
  the tensor cores in 3xTF32 (a TF32 high and low part of each f32
  operand, hi*hi + hi*lo + lo*hi in f32), with the next step's matrix
  streaming in meanwhile and a diag step that follows it applied to its
  sums before they are stored.
  ``block_chain_bwd_kernel`` replaces ``block_pallas.py::_backward_kernel``.
  It sweeps the plan in reverse with O(1) state memory: the matrices
  arrive conj-transposed, and one contraction with them both recovers each
  step's input and pulls the cotangent back. Its three complex products
  per mat step run on the tensor cores as the forward's do (one product
  routine serves both), on a tile of samples per CTA (:func:`bwd_config`).
- ``csrc/block_chain_cluster.cu``, the cluster pair, takes every other plan
  with n <= 16 at any hi/lo split (:func:`uses_cluster_pair`): one sample
  is held by a thread-block cluster of 1 to 8 CTAs, split along the wider
  axis, read across ranks through distributed shared memory
  (:func:`cluster_config`); its products are one tiled complex GEMM on the
  tensor cores in 3xTF32, as K2's, whose operand slabs producer warps stage
  into two shared buffers while consumer warps multiply, and it pads a
  block narrower than a tile with zeros.

The matrix and phase cotangents are batch sums: each CTA (12q pair) or
cluster (cluster pair) sums its samples into its own partial slab, and
``block_chain_reduce`` adds the slabs in a fixed order (no float atomics,
deterministic).

Bound: at 12 qubits (H = L = K = 64) every mat step is a 64x64x64 complex
product per sample, ~21 FMA per byte of state, and at 16 qubits a
256x256x256 one, so the kernels are bound by arithmetic; both pairs keep
the state on chip for the whole chain.

The state keeps one ``[H, L]`` orientation throughout: the Pallas kernel's
transposes exist because Mosaic contracts only the minor dim, and the GPU
indexes the stepped axis directly. Phases and their cotangents are ``[H, L]``
as well, so the wrappers transpose nothing.

Each kernel has a plain PyTorch version beside it (``*_ref``, one for both
pairs), which runs for CPU tensors (the tests) and, on the card, only in
the tests and ``chip_smoke.py``. For a CUDA tensor a wrapper launches its
kernel or raises. ``LAUNCHES`` counts kernel launches and plain-version
calls.

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

MAX_QUBITS = 16  # a sample in a cluster of at most 8 CTAs (cluster_config)
MAX_STEPS = 128  # QC_MAX_STEPS / BC_MAX_STEPS in csrc/block_chain*.cu


LAUNCHES = {
    "block_chain_fwd": 0,
    "block_chain_bwd": 0,
    "block_chain_reduce": 0,
    "block_cluster_fwd": 0,
    "block_cluster_bwd": 0,
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


# -- the CUDA libraries --------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_CLUSTER_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("block_chain")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qc_block_chain_fwd.argtypes = [p] * 6 + [i, i, i, p, i, i, i, i, p]
        lib.qc_block_chain_bwd.argtypes = [p] * 9 + [i] * 5 + [p, i, i, p]
        lib.qc_block_chain_reduce.argtypes = [p, p, i, i, p]
        for fn in (lib.qc_block_chain_fwd, lib.qc_block_chain_bwd,
                   lib.qc_block_chain_reduce):
            fn.restype = i
        lib.qc_error_string.argtypes = [i]
        lib.qc_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _cluster_lib() -> ctypes.CDLL:
    global _CLUSTER_LIB
    if _CLUSTER_LIB is None:
        lib = ctypes.CDLL(cuda_build.build("block_chain_cluster")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qc_block_cluster_fwd.argtypes = [p] * 6 + [i] * 5 + [p, i, i, p]
        lib.qc_block_cluster_bwd.argtypes = [p] * 9 + [i] * 7 + [p, i, i, p]
        lib.qc_block_cluster_max_clusters.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        for fn in (lib.qc_block_cluster_fwd, lib.qc_block_cluster_bwd,
                   lib.qc_block_cluster_max_clusters):
            fn.restype = i
        lib.qc_error_string.argtypes = [i]
        lib.qc_error_string.restype = ctypes.c_char_p
        _CLUSTER_LIB = lib
    return _CLUSTER_LIB


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


def uses_cluster_pair(plan: KPlan) -> bool:
    """The dispatch rule between the two kernel pairs: the 12-qubit pair
    (csrc/block_chain.cu) takes 10 <= n <= 12 with both blocks at least 32
    wide (so at most 128: its tensor-core tiles are 32 rows deep and its
    CTA holds a whole sample); the cluster pair
    (csrc/block_chain_cluster.cu) takes every other plan."""
    return not (10 <= plan.n <= 12 and min(plan.hb, plan.lb) >= 5)


# the cluster pair's GEMM buffers (csrc/block_chain_cluster.cu): two staged
# slabs of BC_STAGE floats, the second shared with the 4096-entry complex
# write-back buffer
_BC_STAGE_FLOATS = 2 * 12288


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """How the cluster pair holds one sample: clusters of ``fwd_cluster`` /
    ``bwd_cluster`` CTAs splitting H (``part_hi``) or L into equal slices,
    with ``fwd_smem`` / ``bwd_smem`` bytes of shared memory a CTA."""

    fwd_cluster: int
    bwd_cluster: int
    part_hi: bool
    fwd_smem: int
    bwd_smem: int


def cluster_config(plan: KPlan) -> ClusterConfig:
    """The cluster pair's partition of ``plan`` (launch_config in
    csrc/block_chain_cluster.cu checks it): the ranks split the wider axis
    (H on a tie); a cluster is the least power of two CTAs that keeps a
    CTA's state planes (forward: the state, backward: state and cotangent)
    within 128 KiB and a rank's share of a fiber of the wider axis within
    the 4096-entry write-back buffer. Forward 1 / 1 / 2 / 4 CTAs and
    backward 1 / 2 / 4 / 8 at 13 / 14 / 15 / 16 qubits on the balanced
    split; one CTA at n <= 12."""
    wide = 1 << max(0, max(plan.hb, plan.lb) - 12)
    fwd = max(1 << max(0, plan.n - 14), wide)
    bwd = max(1 << max(0, plan.n - 13), wide)

    def smem(planes: int, c: int) -> int:
        return 4 * (planes * (1 << plan.n) // c + _BC_STAGE_FLOATS)

    return ClusterConfig(fwd, bwd, plan.hb >= plan.lb, smem(2, fwd), smem(4, bwd))


FWD_TILE = 4  # QC_FWD_TILE in csrc/block_chain.cu: K1's register tile
SMEM_MAX = 232448  # QC_SMEM_MAX: a CTA's opt-in shared memory on sm_90 (227 KiB)


def fwd_config(plan: KPlan, batch: int, sms: int) -> Tuple[int, int, int]:
    """(samples per tile, matrix buffers, shared bytes) of one forward CTA
    of the 12q pair for ``batch`` samples on a card of ``sms`` SMs, the
    rule :func:`fwd_launch` launches with (the CUDA entry only checks that
    the tile fits): two [K, K] re/im matrix buffers where both blocks are
    at most 64 wide, else one; of the tiles of 1 to FWD_TILE samples whose
    [H, L] re/im planes fit beside them, the one that minimises rounds *
    (T + 1), with rounds the most tiles a CTA takes (a tile costs about
    one sample more than its samples: the matrix fragments it splits, its
    barriers), ties to the larger T. At 12 qubits on 132 SMs: 4 samples at
    B = 6144, 3 at B = 682."""
    km = 1 << max(plan.hb, plan.lb)
    bufs = 2 if km <= 64 else 1
    mat_floats, sample_floats = 2 * bufs * km * km, 2 * (1 << plan.n)
    g = max(1, min(batch, sms))

    def cost(t: int) -> int:
        tiles = -(-batch // t)
        return -(-tiles // g) * (t + 1)

    t_max = min(FWD_TILE, (SMEM_MAX // 4 - mat_floats) // sample_floats)
    tile = min(range(t_max, 0, -1), key=cost)  # the first minimum: the larger T
    return tile, bufs, 4 * (mat_floats + sample_floats * tile)


@dataclasses.dataclass(frozen=True)
class FwdLaunch:
    """K1's launch: samples a tile, matrix buffers, shared bytes a CTA and
    the grid (CTAs, each walking the tiles)."""

    samples_per_tile: int
    matrix_buffers: int
    smem_per_cta: int
    grid: int


def fwd_launch(device: torch.device, plan: KPlan, b: int) -> FwdLaunch:
    """The launch :func:`block_chain_fwd` makes for ``b`` samples of
    ``plan`` (a 12q-pair plan) on ``device``: :func:`fwd_config` on the
    card's SM count, and no more CTAs than tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tile, bufs, smem = fwd_config(plan, b, sms)
    return FwdLaunch(tile, bufs, smem, min(grid_size(device, b), -(-b // tile)))


def bwd_config(plan: KPlan) -> Tuple[int, int, int]:
    """(samples per tile, Mct buffers, shared bytes) of one backward CTA of
    the 12q pair (bwd_config in csrc/block_chain.cu): a tile of 2 samples'
    state and cotangent planes and a double-buffered [K, K] re/im matrix
    where both blocks are at most 64 wide, else (a 128-wide block at 12
    qubits) 1 sample and 1 buffer; either fits a CTA's shared memory."""
    km = 1 << max(plan.hb, plan.lb)
    tile = bufs = 2 if km <= 64 else 1
    return tile, bufs, 4 * (4 * tile * (1 << plan.n) + 2 * bufs * km * km)


def check_plan(plan: KPlan) -> None:
    """Raise unless the CUDA kernels can run ``plan``: n <= 16 (a sample in
    a cluster of at most 8 CTAs) and at most MAX_STEPS steps. Every split
    of those is taken, by one pair or the other (:func:`uses_cluster_pair`)."""
    if plan.n > MAX_QUBITS:
        raise ValueError(
            f"block_chain kernels take n <= {MAX_QUBITS} (a sample in a "
            f"cluster of at most 8 CTAs); got n = {plan.n}"
        )
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


_MAX_CLUSTERS = {}


def max_clusters(device: torch.device, plan: KPlan, bwd: bool) -> int:
    """The most clusters of the cluster pair's forward or backward kernel
    that ``device`` holds at once (cudaOccupancyMaxActiveClusters), asked
    once per device and shape. Raises where not one fits."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    cfg = cluster_config(plan)
    c = cfg.bwd_cluster if bwd else cfg.fwd_cluster
    key = (index, bwd, plan.hb, plan.lb)
    if key not in _MAX_CLUSTERS:
        lib = _cluster_lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.qc_block_cluster_max_clusters(
                int(bwd), plan.hb, plan.lb, c, int(cfg.part_hi), ctypes.byref(out))
        _raise_on(lib, err, "cudaOccupancyMaxActiveClusters")
        if out.value < 1:
            raise RuntimeError(
                f"no cluster of {c} CTAs with "
                f"{cfg.bwd_smem if bwd else cfg.fwd_smem} bytes of shared "
                "memory each fits on the card")
        _MAX_CLUSTERS[key] = out.value
    return _MAX_CLUSTERS[key]


def block_chain_fwd(xr, xi, m, p, plan: KPlan):
    """Forward kernel wrapper; same contract as :func:`block_chain_fwd_ref`.
    Launches the pair :func:`uses_cluster_pair` picks."""
    if _on_cpu(xr):
        return block_chain_fwd_ref(xr, xi, m, p, plan)
    _check_cuda(plan, (xr, xi), m, p)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    b = xr.shape[0]
    if b == 0:
        return yr, yi
    steps, _ = _step_table(plan)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    if uses_cluster_pair(plan):
        lib = _cluster_lib()
        cfg = cluster_config(plan)
        err = lib.qc_block_cluster_fwd(
            xr.data_ptr(), xi.data_ptr(), m.data_ptr(), p.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), b, plan.hb, plan.lb, cfg.fwd_cluster,
            int(cfg.part_hi), steps.ctypes.data, len(plan.steps),
            min(b, max_clusters(xr.device, plan, bwd=False)), stream,
        )
        _raise_on(lib, err, "block_cluster_fwd")
        LAUNCHES["block_cluster_fwd"] += 1
        return yr, yi
    _launch_fwd(xr, xi, m, p, yr, yi, plan, fwd_launch(xr.device, plan, b))
    LAUNCHES["block_chain_fwd"] += 1
    return yr, yi


def _launch_fwd(xr, xi, m, p, yr, yi, plan: KPlan, launch: FwdLaunch) -> None:
    """Launch K1 (the 12q pair's forward) with ``launch``'s tile, matrix
    buffers and grid; the CUDA entry refuses a tile that does not fit."""
    lib = _lib()
    err = lib.qc_block_chain_fwd(
        xr.data_ptr(), xi.data_ptr(), m.data_ptr(), p.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), xr.shape[0], 1 << plan.hb, 1 << plan.lb,
        _step_table(plan)[0].ctypes.data, len(plan.steps), launch.samples_per_tile,
        launch.matrix_buffers, launch.grid,
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(lib, err, "block_chain_fwd")


def grid_size(device: torch.device, b: int) -> int:
    """Persistent grid of the 12q pair: one CTA per SM (its shared memory
    holds a tile of samples), never more than the batch. The forward
    launches fewer where the batch has fewer tiles (:func:`fwd_launch`)."""
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
    """Backward kernel alone (CUDA tensors only), of the pair
    :func:`uses_cluster_pair` picks: returns (gxr, gxi, partials [G,
    slab]), one slab per CTA (12q pair) or cluster (cluster pair);
    :func:`block_chain_reduce` finishes the batch sums."""
    _check_cuda(plan, (yr, yi, gr, gi), mct, p)
    h, l = 1 << plan.hb, 1 << plan.lb
    b = yr.shape[0]
    if b == 0:
        raise ValueError("block_chain_bwd needs a non-empty batch")
    steps, mats_total = _step_table(plan)
    slab = mats_total + p.numel()
    gxr, gxi = torch.empty_like(yr), torch.empty_like(yi)
    stream = torch.cuda.current_stream(yr.device).cuda_stream
    if uses_cluster_pair(plan):
        lib = _cluster_lib()
        cfg = cluster_config(plan)
        g = min(b, max_clusters(yr.device, plan, bwd=True))
        partials = torch.empty((g, slab), dtype=torch.float32, device=yr.device)
        err = lib.qc_block_cluster_bwd(
            yr.data_ptr(), yi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
            mct.data_ptr(), p.data_ptr(), gxr.data_ptr(), gxi.data_ptr(),
            partials.data_ptr(), slab, mats_total, b, plan.hb, plan.lb,
            cfg.bwd_cluster, int(cfg.part_hi), steps.ctypes.data, len(plan.steps),
            g, stream,
        )
        _raise_on(lib, err, "block_cluster_bwd")
        LAUNCHES["block_cluster_bwd"] += 1
        return gxr, gxi, partials
    lib = _lib()
    g = grid_size(yr.device, b)
    partials = torch.empty((g, slab), dtype=torch.float32, device=yr.device)
    err = lib.qc_block_chain_bwd(
        yr.data_ptr(), yi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        mct.data_ptr(), p.data_ptr(), gxr.data_ptr(), gxi.data_ptr(),
        partials.data_ptr(), slab, mats_total, b, h, l,
        steps.ctypes.data, len(plan.steps), g, stream,
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
