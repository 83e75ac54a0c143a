"""Diagonal-gate fusion (port of qcpinn_tpu/ops/diag_fusion.py).

RZ / PhaseShift / CZ / CRZ are diagonal in the computational basis and
commute, so a maximal commuting run of them becomes one :class:`DiagRun`
with phase vector

    phi(s) = Bits(s) . (W1^T theta) + sum_k theta_k b_c(k)(s) b_t(k)(s)
           + c1 . theta + const(s)

applied as one elementwise complex multiply over the ``[B, 2^n]`` state.
Phases follow PennyLane's conventions exactly (including RZ's global
e^{-i theta/2}), so fused and unfused programs agree as states.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple, Union

import numpy as np
import torch

from .program import Op, Program

DIAGONAL_KINDS = {"rz", "ps", "crz", "cz"}


@functools.lru_cache(maxsize=32)
def bit_matrix(n: int) -> np.ndarray:
    """[2^n, n] float32: Bits[s, w] = bit of wire w in basis state s
    (wire 0 = most significant)."""
    idx = np.arange(1 << n, dtype=np.int64)
    return ((idx[:, None] >> (n - 1 - np.arange(n))[None, :]) & 1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DiagRun:
    """A fused run of diagonal gates.

    - w1: [P, n] linear coefficients on Bits columns
    - c1: [P] parameter-linear scalar (global-phase) coefficients
    - quad: (ctrl, tgt, local param index) bilinear terms
    - const_pairs: (a, b) CZ wire pairs (static pi * b_a * b_b)
    - pidx: parameter indices consumed by this run (into the layer vector)
    """

    n: int
    pidx: Tuple[int, ...]
    w1: np.ndarray
    c1: np.ndarray
    quad: Tuple[Tuple[int, int, int], ...]
    const_pairs: Tuple[Tuple[int, int], ...]

    def constants(self, device) -> dict:
        """Everything :meth:`phases` needs besides the parameters, on
        ``device``, built once per device: the bit planes, the linear and
        global-phase coefficients, the bilinear pair planes with their
        parameter indices, the static CZ phases and the run's parameter
        indices. A call then copies nothing from the host, so it can be
        captured in a CUDA graph. The cache lives beside the dataclass
        fields (a frozen dataclass still has a ``__dict__``)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_on_device", {})
        if device not in cache:
            bits_np = bit_matrix(self.n)

            def dev(a, dtype=torch.float32):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

            c = {"bits_t": dev(bits_np.T), "w1": dev(self.w1), "c1": dev(self.c1),
                 "pidx": dev(self.pidx, torch.long)}
            if self.quad:
                c["pair"] = dev(np.stack(
                    [bits_np[:, q] * bits_np[:, t] for q, t, _ in self.quad]))
                c["ks"] = dev([q[2] for q in self.quad], torch.long)
            if self.const_pairs:
                cvec = np.zeros(1 << self.n, dtype=np.float32)
                for a, t in self.const_pairs:
                    cvec += np.pi * bits_np[:, a] * bits_np[:, t]
                c["cvec"] = dev(cvec)
            cache[device] = c
        return cache[device]

    def phases(self, params: torch.Tensor) -> torch.Tensor:
        """params: [P_layer] or [B, P_layer] -> phases [2^n] / [B, 2^n]."""
        c = self.constants(params.device)
        theta = params[..., c["pidx"]]
        # linear: Bits @ (W1^T theta), plus the scalar global-phase part
        lin_w = theta @ c["w1"]  # [..., n]
        phi = lin_w @ c["bits_t"]  # [..., 2^n]
        phi = phi + torch.sum(theta * c["c1"], dim=-1, keepdim=True)
        if self.quad:
            # bilinear: sum_k theta_k b_c(k) b_t(k), as theta[ks] @ [K, 2^n]
            phi = phi + theta[..., c["ks"]] @ c["pair"]
        if self.const_pairs:
            phi = phi + c["cvec"]
        return phi

    def apply(self, state: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        phi = self.phases(params)
        if phi.ndim == 1:
            phi = phi[None, :]
        return state * torch.polar(torch.ones_like(phi), phi)


FusedProgram = Tuple[Union[Op, DiagRun], ...]


def split_diag_run(run: DiagRun, hb: int):
    """Split a run into independent (hi, lo) runs across the hi/lo wire cut,
    possible iff no bilinear (CRZ) or static CZ term crosses it: the phase
    then separates as phi[h, l] = phi_hi[h] + phi_lo[l]. Returns None when a
    term crosses. The global-phase part (c1) rides the hi factor. Either
    side comes back None when it is the identity."""
    for c, t, _ in run.quad:
        if (c < hb) != (t < hb):
            return None
    for a, b in run.const_pairs:
        if (a < hb) != (b < hb):
            return None
    lb = run.n - hb
    hi = DiagRun(
        hb,
        run.pidx,
        run.w1[:, :hb],
        run.c1,
        tuple(q for q in run.quad if q[0] < hb),
        tuple(p for p in run.const_pairs if p[0] < hb),
    )
    lo = DiagRun(
        lb,
        run.pidx,
        run.w1[:, hb:],
        np.zeros_like(run.c1),
        tuple((c - hb, t - hb, k) for c, t, k in run.quad if c >= hb),
        tuple((a - hb, b - hb) for a, b in run.const_pairs if a >= hb),
    )

    def trivial(r: DiagRun) -> bool:
        return (
            not r.quad and not r.const_pairs
            and not np.any(r.w1) and not np.any(r.c1)
        )

    return (None if trivial(hi) else hi), (None if trivial(lo) else lo)


def _make_run(n: int, ops: List[Op]) -> DiagRun:
    pidx: List[int] = []
    lin_rows: List[np.ndarray] = []
    c1: List[float] = []
    quad: List[Tuple[int, int, int]] = []
    const_pairs: List[Tuple[int, int]] = []

    def local(p: int) -> int:
        if p in pidx:
            return pidx.index(p)
        pidx.append(p)
        lin_rows.append(np.zeros(n, dtype=np.float32))
        c1.append(0.0)
        return len(pidx) - 1

    for op in ops:
        if op.kind == "rz":
            # diag(e^{-i t/2}, e^{i t/2}): phi = t * b_w - t/2
            k = local(op.pidx[0])
            lin_rows[k][op.wires[0]] += 1.0
            c1[k] += -0.5
        elif op.kind == "ps":
            k = local(op.pidx[0])
            lin_rows[k][op.wires[0]] += 1.0
        elif op.kind == "crz":
            # phi = b_c * (t b_t - t/2) = t b_c b_t - (t/2) b_c
            k = local(op.pidx[0])
            c, t = op.wires
            quad.append((c, t, k))
            lin_rows[k][c] += -0.5
        elif op.kind == "cz":
            const_pairs.append(op.wires)
        else:  # pragma: no cover
            raise ValueError(f"not diagonal: {op.kind}")

    w1 = np.stack(lin_rows, axis=0) if lin_rows else np.zeros((0, n), np.float32)
    return DiagRun(
        n=n,
        pidx=tuple(pidx),
        w1=w1,
        c1=np.asarray(c1, dtype=np.float32),
        quad=tuple(quad),
        const_pairs=tuple(const_pairs),
    )


def fuse_diagonals(program: Program, n: int, min_run: int = 2) -> FusedProgram:
    """Greedy commuting-run scheduler: a diagonal gate joins the open run
    unless one of its wires was touched by a non-diagonal gate since the run
    started (then the run is flushed and a new one starts). Runs shorter
    than ``min_run`` stay individual gates."""
    out: List[Union[Op, DiagRun]] = []
    run: List[Op] = []
    run_pos: List[int] = []  # position in `out` where the run will be placed
    blocked: set = set()  # wires touched by non-diagonal ops since run start

    def flush():
        nonlocal run, blocked
        if not run:
            return
        if len(run) >= min_run:
            out.insert(run_pos[0], _make_run(n, run))
        else:
            for i, op in enumerate(run):
                out.insert(run_pos[0] + i, op)
        run = []
        run_pos.clear()
        blocked = set()

    for op in program:
        if op.kind in DIAGONAL_KINDS:
            if run and any(w in blocked for w in op.wires):
                flush()
            if not run:
                blocked = set()
                run_pos.append(len(out))
            run.append(op)
        else:
            blocked.update(op.wires)
            out.append(op)
    flush()
    return tuple(out)
