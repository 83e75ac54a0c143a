"""Batched statevector engine (port of qcpinn_tpu/ops/statevector.py).

State: ``[B, 2^n]`` complex64, wire 0 the most significant bit of the basis
index (PennyLane wire order). Gates act through bit-split reshapes; the
``<Z_i>`` readout is one ``[B, 2^n] @ [2^n, n]`` matmul with a +/-1 sign
matrix. Gate matrices may be batched over the leading axis (``[B, 2, 2]``),
which is how per-sample encoding angles are applied.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gates
from .gates import host_const, untransformed

CDTYPE = torch.complex64
RDTYPE = torch.float32


def _as_gate(m, like: torch.Tensor) -> torch.Tensor:
    if isinstance(m, np.ndarray):
        return host_const(m, like.device)
    return torch.as_tensor(m, dtype=CDTYPE, device=like.device)


def zero_state(batch: int, n: int, device=None) -> torch.Tensor:
    """|0...0> for every batch element: ``[B, 2^n]`` complex64."""
    state = torch.zeros((batch, 1 << n), dtype=CDTYPE, device=device)
    state[:, 0] = 1.0
    return state


def apply_1q(state: torch.Tensor, n: int, wire: int, m) -> torch.Tensor:
    """Apply a 1-qubit gate ``m`` ([2,2] or [B,2,2]) on ``wire``."""
    m = _as_gate(m, state)
    b = state.shape[0]
    s = state.reshape(b, 1 << wire, 2, 1 << (n - 1 - wire))
    a0 = s[:, :, 0, :]
    a1 = s[:, :, 1, :]
    if m.ndim == 2:
        b0 = m[0, 0] * a0 + m[0, 1] * a1
        b1 = m[1, 0] * a0 + m[1, 1] * a1
    else:
        m = m[:, :, :, None, None]  # [B,2,2,1,1] broadcasting over (lo, hi)
        b0 = m[:, 0, 0] * a0 + m[:, 0, 1] * a1
        b1 = m[:, 1, 0] * a0 + m[:, 1, 1] * a1
    return torch.stack([b0, b1], dim=2).reshape(b, 1 << n)


def apply_2q(
    state: torch.Tensor, n: int, wire_a: int, wire_b: int, u
) -> torch.Tensor:
    """Apply a 2-qubit gate ``u`` ([4,4] or [B,4,4], (wire_a, wire_b)
    index order) on (wire_a, wire_b)."""
    if wire_a == wire_b:
        raise ValueError("2-qubit gate needs distinct wires")
    u = _as_gate(u, state)
    batched = u.ndim == 3
    u4 = u.reshape(u.shape[:-2] + (2, 2, 2, 2))
    w1, w2 = (wire_a, wire_b) if wire_a < wire_b else (wire_b, wire_a)
    if wire_a > wire_b:
        # re-express u in ascending-wire index order
        perm = (0, 2, 1, 4, 3) if batched else (1, 0, 3, 2)
        u4 = u4.permute(perm)
    b = state.shape[0]
    s = state.reshape(
        b, 1 << w1, 2, 1 << (w2 - w1 - 1), 2, 1 << (n - 1 - w2)
    )
    if batched:
        out = torch.einsum("bklij,baicjd->bakcld", u4, s)
    else:
        out = torch.einsum("klij,baicjd->bakcld", u4, s)
    return out.reshape(b, 1 << n)


def apply_ctrl_1q(
    state: torch.Tensor, n: int, ctrl: int, tgt: int, m
) -> torch.Tensor:
    """Controlled 1-qubit gate (``m`` on ``tgt`` when ``ctrl`` is 1):
    CNOT, CRX, CRY, CRZ, by the elementwise masked-flip formulation."""
    m = _as_gate(m, state)
    b = state.shape[0]
    w1, w2 = (ctrl, tgt) if ctrl < tgt else (tgt, ctrl)
    s = state.reshape(
        b, 1 << w1, 2, 1 << (w2 - w1 - 1), 2, 1 << (n - 1 - w2)
    )
    ctrl_axis = 2 if ctrl < tgt else 4
    tgt_axis = 4 if ctrl < tgt else 2

    def along(vec, axis, batched):
        shape = [1] * 6
        shape[axis] = 2
        if batched:
            shape[0] = b
        return vec.reshape(shape)

    sel = along(host_const(np.float32([0.0, 1.0]), state.device, state.dtype),
                ctrl_axis, False)
    swapped = torch.flip(s, dims=(tgt_axis,))
    if m.ndim == 2:
        diag = along(torch.stack([m[0, 0], m[1, 1]]), tgt_axis, False)
        off = along(torch.stack([m[0, 1], m[1, 0]]), tgt_axis, False)
    else:
        diag = along(torch.stack([m[:, 0, 0], m[:, 1, 1]], dim=1), tgt_axis, True)
        off = along(torch.stack([m[:, 0, 1], m[:, 1, 0]], dim=1), tgt_axis, True)
    out = s * (1.0 - sel) + sel * (diag * s + off * swapped)
    return out.reshape(b, 1 << n)


@functools.lru_cache(maxsize=32)
def _z_sign_matrix(n: int) -> np.ndarray:
    """``[2^n, n]`` float32: entry (s, w) = +1 if bit_w(s) = 0 else -1."""
    idx = np.arange(1 << n, dtype=np.int64)
    bits = (idx[:, None] >> (n - 1 - np.arange(n))[None, :]) & 1
    return (1.0 - 2.0 * bits).astype(np.float32)


@functools.lru_cache(maxsize=32)
def z_sign(n: int, device) -> torch.Tensor:
    """The ``[2^n, n]`` sign matrix on ``device``, built once per device."""
    with untransformed():
        return torch.as_tensor(_z_sign_matrix(n), device=device)


def z_expvals(state: torch.Tensor, n: int) -> torch.Tensor:
    """``<Z_w>`` for every wire: ``[B, n]`` float32 (one matmul)."""
    probs = (state * torch.conj(state)).real.to(RDTYPE)
    return probs @ z_sign(n, state.device)


@functools.lru_cache(maxsize=32)
def _parity_sign_vector(n: int) -> np.ndarray:
    """``[2^n]`` float32 vector with entry s = (-1)^popcount(s): the
    eigenvalues of the global Z⊗...⊗Z observable."""
    idx = np.arange(1 << n, dtype=np.int64)
    pop = np.zeros_like(idx)
    for w in range(n):
        pop += (idx >> w) & 1
    return (1.0 - 2.0 * (pop % 2)).astype(np.float32)


def global_z_expval(state: torch.Tensor, n: int) -> torch.Tensor:
    """``<Z⊗Z⊗...⊗Z>``: ``[B]`` float32, the global-parity observable the
    crystal-growth pipeline reads out
    (hybrid_qpinn_2dcrystal_ibmtest.py:133-135, SparsePauliOp 'Z'*n)."""
    probs = (state * torch.conj(state)).real.to(RDTYPE)
    return probs @ host_const(_parity_sign_vector(n), state.device, RDTYPE)


def encode_angle(state: torch.Tensor, n: int, x: torch.Tensor) -> torch.Tensor:
    """AngleEmbedding with rotation='X' (nn/DVQuantumLayer.py:182):
    ``RX(x_w)`` on wire w, batched over samples."""
    for w in range(n):
        state = apply_1q(state, n, w, gates.rx(x[:, w]))
    return state


def encode_angle_product(x: torch.Tensor, n: int) -> torch.Tensor:
    """AngleEmbedding built directly as a product state: amplitude s is
    ``(-i)^popcount(s) * prod_w (cos or sin)(x_w / 2)``. Equals
    ``encode_angle(zero_state(B, n), n, x)``."""
    c = torch.cos(x / 2.0).to(RDTYPE)
    s = torch.sin(x / 2.0).to(RDTYPE)
    masks, phase = _product_consts(n, x.device)
    mag = torch.ones((x.shape[0], 1 << n), dtype=RDTYPE, device=x.device)
    for w in range(n):  # wire 0 is the most significant bit
        mag = mag * torch.where(masks[w][None, :], s[:, w : w + 1], c[:, w : w + 1])
    return mag.to(CDTYPE) * phase[None, :]


@functools.lru_cache(maxsize=32)
def _product_consts(n: int, device):
    """(bit masks [n, 2^n] bool, (-i)^popcount [2^n]) on ``device``, built
    once per device."""
    from .diag_fusion import bit_matrix

    bits = bit_matrix(n)  # [2^n, n] static
    pop = bits.sum(axis=1).astype(np.int64) % 4
    phase = np.array([1, -1j, -1, 1j], dtype=np.complex64)[pop]
    with untransformed():
        return (torch.as_tensor(bits.T == 1.0, device=device),
                torch.as_tensor(phase, device=device))


def encode_amplitude(x: torch.Tensor, n: int, eps: float = 1e-12) -> torch.Tensor:
    """AmplitudeEmbedding(normalize=True, pad_with=0.0)
    (nn/DVQuantumLayer.py:177-180): pad features to 2^n and L2-normalize
    per sample. Returns the prepared state directly."""
    b, f = x.shape
    dim = 1 << n
    if f > dim:
        raise ValueError(f"{f} features do not fit in {n} qubits")
    padded = torch.nn.functional.pad(x.to(RDTYPE), (0, dim - f))
    norm = torch.sqrt(torch.sum(padded * padded, dim=1, keepdim=True) + eps)
    return (padded / norm).to(CDTYPE)
