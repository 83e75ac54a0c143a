"""Continuous-variable (photonic) simulation in a truncated Fock space (port
of qcpinn_tpu/ops/fock.py).

The m-mode state is a dense ``[B, d^m]`` complex tensor (d = cutoff_dim),
mode 0 the most significant digit of the basis index; gates are dense d x d
(or d^2 x d^2, in (mode_a, mode_b) index order) matrices applied with the
qubit engine's reshapes, for the whole batch at once.

Operator conventions follow PennyLane/SF with hbar = 2:

  a|n> = sqrt(n)|n-1>;     x = a + a^dag  (since sqrt(hbar/2) = 1)
  Rotation(phi)      = exp(i phi n)                      (diagonal)
  Displacement(r,p)  = exp(alpha a^dag - alpha* a),  alpha = r e^{ip}
  Squeezing(r,p)     = exp((z* a^2 - z a^dag^2)/2),  z = r e^{ip}
  Kerr(kappa)        = exp(i kappa n^2)                  (diagonal)
  CrossKerr(kappa)   = exp(i kappa n_i n_j)              (diagonal, 2-mode)
  CubicPhase(gamma)  = exp(i gamma x^3 / (3 hbar))
  Beamsplitter(t,p)  = exp(t (e^{ip} a b^dag - e^{-ip} a^dag b))

Dense gates are the exponential of the truncated generator (``*_generator``
gives the generator, batched over its parameters), by :func:`expm`: scaling
and squaring around a degree-18 Taylor polynomial, with the number of
squarings chosen on the device, per matrix, from its 1-norm. The JAX package
uses ``jax.scipy.linalg.expm``; ``torch.linalg.matrix_exp`` picks its degree
on the host (a device-to-host copy a call), which a CUDA graph cannot
capture, so the port has its own, made of matmuls and ``where`` alone: it
captures, and ``torch.func.jvp`` and autograd differentiate through it to
any order.

Precision: complex64 by default; ``QCPINN_FOCK_DTYPE=complex128`` in the
environment switches the whole CV path to double (read at import; the
module's ``CDTYPE``/``FDTYPE`` are read at every call).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from .gates import host_const

CDTYPE = torch.complex64
FDTYPE = torch.float32
if os.environ.get("QCPINN_FOCK_DTYPE") == "complex128":
    CDTYPE = torch.complex128
    FDTYPE = torch.float64

# The largest 1-norm whose degree-18 Taylor polynomial is exp to the
# dtype's unit roundoff (the theta_18 of Bader, Blanes & Casas 2019, the
# values torch.linalg.matrix_exp uses); a matrix of larger norm is scaled
# by 2^-s first and squared s times after.
TAYLOR_DEGREE = 18
THETA = {torch.complex64: 3.010066362817634, torch.complex128: 1.090863719290036}
# as jax.scipy.linalg.expm's max_squarings: a matrix that needs more gives NaN
MAX_SQUARINGS = 16
_PS_BLOCK = 4  # Paterson-Stockmeyer block: powers X^1..X^4, Horner in X^4


@functools.lru_cache(maxsize=32)
def lowering(d: int) -> np.ndarray:
    """Truncated annihilation operator a: a[m, n] = sqrt(n) delta_{m, n-1}
    (complex128; cast to the engine's dtype on the device)."""
    return np.diag(np.sqrt(np.arange(1, d, dtype=np.float64)), 1).astype(np.complex128)


@functools.lru_cache(maxsize=32)
def number_diag(d: int) -> np.ndarray:
    return np.arange(d, dtype=np.float64)


@functools.lru_cache(maxsize=32)
def _beamsplitter_terms(d: int) -> np.ndarray:
    """[2, d^2, d^2]: a1 a2^dag and a1^dag a2, a1 = a (x) I, a2 = I (x) a."""
    a = lowering(d)
    eye = np.eye(d, dtype=np.complex128)
    a1, a2 = np.kron(a, eye), np.kron(eye, a)
    return np.stack([a1 @ a2.conj().T, a1.conj().T @ a2])


def _const(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A fixed operator as a cached device constant (built outside any
    ``torch.func`` transform, so nested jvps can use it)."""
    return host_const(a, device, dtype or CDTYPE)


def _c(x: torch.Tensor) -> torch.Tensor:
    """A real parameter tensor in the engine's complex dtype."""
    return torch.as_tensor(x).to(FDTYPE).to(CDTYPE)


def _bcast(x: torch.Tensor) -> torch.Tensor:
    return x[..., None, None]


# -- the matrix exponential ----------------------------------------------------


def expm(A: torch.Tensor) -> torch.Tensor:
    """exp(A) of each ``[..., n, n]`` complex matrix, with no host
    synchronisation. s = max(0, ceil(log2(|A|_1 / theta_18))); the degree-18
    Taylor polynomial of A / 2^s (Paterson-Stockmeyer: 3 products for the
    powers, 4 for Horner's rule in A^4), then MAX_SQUARINGS squarings each
    kept where s exceeds its index. NaN where s > MAX_SQUARINGS, as
    ``jax.scipy.linalg.expm`` gives."""
    theta = THETA[A.dtype]
    norm = A.abs().sum(dim=-2).amax(dim=-1)
    s = torch.clamp(torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / theta)), min=0.0)
    X = A / _bcast(torch.exp2(s)).to(A.dtype)
    eye = _const(np.eye(A.shape[-1]), A.device, A.dtype)
    powers = [eye, X]
    for _ in range(2, _PS_BLOCK + 1):
        powers.append(powers[-1] @ X)
    coef = [1.0 / math.factorial(k) for k in range(TAYLOR_DEGREE + 1)]
    out = None
    for j in reversed(range(TAYLOR_DEGREE // _PS_BLOCK + 1)):
        block = sum(coef[j * _PS_BLOCK + i] * powers[i] for i in range(_PS_BLOCK)
                    if j * _PS_BLOCK + i <= TAYLOR_DEGREE)
        out = block if out is None else block + out @ powers[_PS_BLOCK]
    for k in range(MAX_SQUARINGS):
        out = torch.where(_bcast(s > k), out @ out, out)
    return torch.where(_bcast(s > MAX_SQUARINGS), torch.full_like(out, math.nan), out)


# -- gate generators and gates ---------------------------------------------------


def displacement_generator(r, phi, d: int) -> torch.Tensor:
    """alpha a^dag - alpha* a, alpha = r e^{i phi}: [..., d, d]."""
    a = _const(lowering(d), torch.as_tensor(r).device)
    alpha = _bcast(_c(r) * torch.exp(1j * _c(phi)))
    return alpha * a.mH - torch.conj(alpha) * a


def displacement(r, phi, d: int) -> torch.Tensor:
    return expm(displacement_generator(r, phi, d))


def squeezing_generator(r, phi, d: int) -> torch.Tensor:
    """(z* a^2 - z a^dag^2) / 2, z = r e^{i phi}: [..., d, d]."""
    a = lowering(d)
    a2 = _const(a @ a, torch.as_tensor(r).device)
    z = _bcast(_c(r) * torch.exp(1j * _c(phi)))
    return 0.5 * (torch.conj(z) * a2 - z * a2.mH)


def squeezing(r, phi, d: int) -> torch.Tensor:
    return expm(squeezing_generator(r, phi, d))


def rotation_diag(phi, d: int) -> torch.Tensor:
    """The diagonal of Rotation(phi), exp(i phi n): [..., d]."""
    n = _const(number_diag(d), torch.as_tensor(phi).device)
    return torch.exp(1j * _c(phi)[..., None] * n)


def rotation(phi, d: int) -> torch.Tensor:
    return torch.diag_embed(rotation_diag(phi, d))


def kerr_diag(kappa, d: int) -> torch.Tensor:
    """The diagonal of Kerr(kappa), exp(i kappa n^2): [..., d]."""
    n = number_diag(d)
    n2 = _const(n * n, torch.as_tensor(kappa).device)
    return torch.exp(1j * _c(kappa)[..., None] * n2)


def kerr(kappa, d: int) -> torch.Tensor:
    return torch.diag_embed(kerr_diag(kappa, d))


def cubic_phase_generator(gamma, d: int, hbar: float = 2.0) -> torch.Tensor:
    """i gamma x^3 / (3 hbar), x = (a + a^dag) sqrt(hbar / 2): [..., d, d]."""
    a = lowering(d)
    x = (a + a.conj().T) * np.sqrt(hbar / 2.0)
    x3 = _const(x @ x @ x / (3.0 * hbar), torch.as_tensor(gamma).device)
    return 1j * _bcast(_c(gamma)) * x3


def cubic_phase(gamma, d: int, hbar: float = 2.0) -> torch.Tensor:
    return expm(cubic_phase_generator(gamma, d, hbar))


def beamsplitter_generator(theta, phi, d: int) -> torch.Tensor:
    """theta (e^{i phi} a1 a2^dag - e^{-i phi} a1^dag a2): [..., d^2, d^2]
    in (mode_a, mode_b) index order."""
    terms = _const(_beamsplitter_terms(d), torch.as_tensor(theta).device)
    ephi = _bcast(torch.exp(1j * _c(phi)))
    return _bcast(_c(theta)) * (ephi * terms[0] - torch.conj(ephi) * terms[1])


def beamsplitter(theta, phi, d: int) -> torch.Tensor:
    """Two-mode [..., d^2, d^2] in (mode_a, mode_b) index order."""
    return expm(beamsplitter_generator(theta, phi, d))


def cross_kerr_diag(kappa, d: int) -> torch.Tensor:
    """Diagonal of exp(i kappa n_i n_j) as a [..., d, d] phase table."""
    n = number_diag(d)
    nn = _const(np.outer(n, n), torch.as_tensor(kappa).device)
    return torch.exp(1j * _bcast(_c(kappa)) * nn)


# -- state manipulation --------------------------------------------------------


def vacuum(batch: int, m: int, d: int, device=None) -> torch.Tensor:
    state = torch.zeros((batch, d**m), dtype=CDTYPE, device=device)
    state[:, 0] = 1.0
    return state


def _split_1m(state, m, d, mode):
    return state.reshape(state.shape[0], d**mode, d, d ** (m - 1 - mode))


def apply_1m(state: torch.Tensor, m: int, d: int, mode: int, u: torch.Tensor) -> torch.Tensor:
    """Apply a [d, d] (or batched [B, d, d]) one-mode gate."""
    s = _split_1m(state, m, d, mode)
    out = (u if u.ndim == 2 else u[:, None]) @ s
    return out.reshape(state.shape)


def apply_diag_1m(state: torch.Tensor, m: int, d: int, mode: int,
                  diag: torch.Tensor) -> torch.Tensor:
    """Apply a diagonal one-mode gate given by its [d] (or [B, d])
    diagonal."""
    s = _split_1m(state, m, d, mode)
    out = s * (diag[:, None] if diag.ndim == 2 else diag)[..., None]
    return out.reshape(state.shape)


def _split_2m(state, m, d, w1, w2):
    return state.reshape(state.shape[0], d**w1, d, d ** (w2 - w1 - 1), d,
                         d ** (m - 1 - w2))


def apply_2m(state: torch.Tensor, m: int, d: int, mode_a: int, mode_b: int,
             u: torch.Tensor) -> torch.Tensor:
    """Apply a [d^2, d^2] two-mode gate given in (mode_a, mode_b) order."""
    w1, w2 = (mode_a, mode_b) if mode_a < mode_b else (mode_b, mode_a)
    u4 = u.reshape(d, d, d, d)
    if mode_a > mode_b:
        u4 = u4.permute(1, 0, 3, 2)
    out = torch.einsum("klij,baicjd->bakcld", u4, _split_2m(state, m, d, w1, w2))
    return out.reshape(state.shape)


def apply_diag_2m(state: torch.Tensor, m: int, d: int, mode_a: int, mode_b: int,
                  table: torch.Tensor) -> torch.Tensor:
    """Apply a diagonal two-mode phase table [d, d] (CrossKerr)."""
    w1, w2 = (mode_a, mode_b) if mode_a < mode_b else (mode_b, mode_a)
    t = table if mode_a < mode_b else table.T
    out = _split_2m(state, m, d, w1, w2) * t[:, None, :, None]
    return out.reshape(state.shape)


def mode_marginals(state: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """P(n photons in mode w): [B, m, d]."""
    probs = (state * torch.conj(state)).real
    return torch.stack([_split_1m(probs, m, d, w).sum(dim=(1, 3)) for w in range(m)], dim=1)


def number_expvals(state: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """<n_w> for every mode: [B, m] (nn/CVNeuralNetwork1.py:81-83 readout)."""
    n = _const(number_diag(d), state.device, FDTYPE)
    return torch.sum(mode_marginals(state, m, d) * n, dim=-1)


def quad_x_expvals(state: torch.Tensor, m: int, d: int, hbar: float = 2.0) -> torch.Tensor:
    """<x_w> = <a + a^dag> * sqrt(hbar/2) per mode: [B, m]
    (CVNeuralNetwork2.py:65-68 QuadOperator(phi=0) readout)."""
    a = lowering(d)
    x_op = _const((a + a.conj().T) * np.sqrt(hbar / 2.0), state.device)
    out = []
    for w in range(m):
        s = _split_1m(state, m, d, w)
        out.append(torch.sum(torch.conj(s) * (x_op @ s), dim=(1, 2, 3)).real)
    return torch.stack(out, dim=1)
