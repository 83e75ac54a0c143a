"""Plain PyTorch building blocks of the benchmark's references.

Nothing here imports the program under test. Everything is written from
the published definitions: PennyLane's gate conventions (wire 0 the most
significant bit of a basis index), a statevector updated gate by gate,
optax's clip-by-global-norm and Adam, and second-order forward jets.

A jet is one tensor whose leading axis holds its channels: the value, the
first derivative along each of ``nd`` input directions, then the second
derivative along each direction listed in ``second``. Every input direction
moves on its own, so a second-order channel needs only its own first-order
one. Linear maps act on every channel alike (a bias on the value only); a
function of one argument follows the chain rule, ``y' = f' x'``,
``y'' = f' x'' + f'' x'^2``; a product follows Leibniz's rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

CDTYPE = torch.complex64


# -- jets -------------------------------------------------------------------


@dataclass(frozen=True)
class JetSpec:
    nd: int  # first-order directions
    second: Tuple[int, ...]  # directions that also carry a second order

    @property
    def channels(self) -> int:
        return 1 + self.nd + len(self.second)

    def first(self, t: torch.Tensor) -> torch.Tensor:
        return t[1:1 + self.nd]

    def firsts_of_second(self, t: torch.Tensor) -> torch.Tensor:
        return t[[1 + s for s in self.second]]

    def seconds(self, t: torch.Tensor) -> torch.Tensor:
        return t[1 + self.nd:]


def input_jet(x: torch.Tensor, spec: JetSpec) -> torch.Tensor:
    """The jet of the input itself: the unit vector e_c along direction c,
    nothing in the second-order channels. ``x`` is ``[B, nd]``."""
    b, d = x.shape
    out = torch.zeros((spec.channels, b, d), dtype=x.dtype, device=x.device)
    out[0] = x
    for c in range(spec.nd):
        out[1 + c, :, c] = 1.0
    return out


def jet_linear(t: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    out = torch.matmul(t, weight.t())
    if bias is None:
        return out
    return torch.cat([out[:1] + bias, out[1:]])


def jet_unary(t: torch.Tensor, spec: JetSpec, f, f1, f2) -> torch.Tensor:
    x0 = t[0]
    y0, d1 = f(x0), f1(x0)
    parts = [y0[None], d1 * spec.first(t)]
    if spec.second:
        d2 = f2(x0)
        parts.append(d1 * spec.seconds(t) + d2 * spec.firsts_of_second(t) ** 2)
    return torch.cat(parts)


def jet_tanh(t, spec):
    def f1(x):
        y = torch.tanh(x)
        return 1.0 - y * y

    def f2(x):
        y = torch.tanh(x)
        return -2.0 * y * (1.0 - y * y)

    return jet_unary(t, spec, torch.tanh, f1, f2)


def jet_sin(t, spec):
    return jet_unary(t, spec, torch.sin, torch.cos, lambda x: -torch.sin(x))


def jet_cos(t, spec):
    return jet_unary(t, spec, torch.cos, lambda x: -torch.sin(x), lambda x: -torch.cos(x))


def jet_rsqrt(t, spec):
    return jet_unary(t, spec, torch.rsqrt, lambda x: -0.5 * x ** -1.5,
                     lambda x: 0.75 * x ** -2.5)


def jet_mul(a: torch.Tensor, b: torch.Tensor, spec: JetSpec) -> torch.Tensor:
    """Leibniz's rule for an elementwise product of two jets."""
    a0, b0 = a[0], b[0]
    parts = [(a0 * b0)[None], spec.first(a) * b0 + a0 * spec.first(b)]
    if spec.second:
        parts.append(spec.seconds(a) * b0 + 2.0 * spec.firsts_of_second(a)
                     * spec.firsts_of_second(b) + a0 * spec.seconds(b))
    return torch.cat(parts)


def jet_layernorm(t, spec, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis (biased variance), as a composition of
    jets."""
    c = t - torch.mean(t, dim=-1, keepdim=True)
    var = torch.mean(jet_mul(c, c, spec), dim=-1, keepdim=True)
    shifted = torch.cat([var[:1] + eps, var[1:]])
    normed = jet_mul(c, jet_rsqrt(shifted, spec).expand_as(c), spec)
    out = normed * gamma
    return torch.cat([out[:1] + beta, out[1:]])


# -- gates (PennyLane conventions) ------------------------------------------


def _mat(a, b, c, d):
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def ry(t):
    c = torch.cos(t / 2).to(CDTYPE)
    s = torch.sin(t / 2).to(CDTYPE)
    return _mat(c, -s, s, c)


def rz(t):
    e = torch.exp(-0.5j * t.to(CDTYPE))
    z = torch.zeros_like(e)
    return _mat(e, z, z, torch.conj(e))


def rot(phi, theta, omega):
    """PennyLane Rot(phi, theta, omega) = RZ(omega) RY(theta) RZ(phi)."""
    return rz(omega) @ ry(theta) @ rz(phi)


def rot_derivs(kind: str, t: torch.Tensor):
    """(M, dM/dt, d2M/dt2) of RY or RZ at angles ``t`` (any shape):
    M = exp(-i t G / 2), so M' = -i/2 G M and M'' = -M / 4."""
    m = {"ry": ry, "rz": rz}[kind](t)
    g = {"ry": [[0, -1j], [1j, 0]], "rz": [[1, 0], [0, -1]]}[kind]
    g = torch.tensor(g, dtype=CDTYPE, device=t.device)
    return m, -0.5j * (g @ m), -0.25 * m


# -- the statevector, gate by gate -------------------------------------------


def zero_state(lead: Tuple[int, ...], n: int, device) -> torch.Tensor:
    s = torch.zeros((*lead, 1 << n), dtype=CDTYPE, device=device)
    s[..., 0] = 1.0
    return s


def apply_1q(state: torch.Tensor, n: int, wire: int, m: torch.Tensor) -> torch.Tensor:
    """A one-qubit gate ``m`` on ``wire``: ``[2, 2]`` for every sample, or
    ``[..., 2, 2]`` broadcasting against the state's leading axes (one
    matrix a sample). ``state`` is ``[..., 2^n]``."""
    lead = state.shape[:-1]
    s = state.reshape(*lead, 1 << wire, 2, 1 << (n - 1 - wire))
    a0, a1 = s[..., 0, :], s[..., 1, :]
    if m.ndim > 2:
        m = m[..., None, None]
        b0 = m[..., 0, 0, :, :] * a0 + m[..., 0, 1, :, :] * a1
        b1 = m[..., 1, 0, :, :] * a0 + m[..., 1, 1, :, :] * a1
    else:
        b0 = m[0, 0] * a0 + m[0, 1] * a1
        b1 = m[1, 0] * a0 + m[1, 1] * a1
    return torch.stack([b0, b1], dim=-2).reshape(state.shape)


def bit(n: int, wire: int, device) -> torch.Tensor:
    """The value of ``wire``'s bit in every basis index, ``[2^n]``."""
    idx = torch.arange(1 << n, device=device)
    return ((idx >> (n - 1 - wire)) & 1).to(torch.float32)


def z_signs(n: int, device) -> torch.Tensor:
    """``[2^n, n]``: the eigenvalue of Z_w on every basis state."""
    return torch.stack([1.0 - 2.0 * bit(n, w, device) for w in range(n)], dim=1)


def apply_cz(state, n, a, b):
    sign = 1.0 - 2.0 * bit(n, a, state.device) * bit(n, b, state.device)
    return state * sign.to(CDTYPE)


# -- a circuit's state as a jet ----------------------------------------------


def jet_gate(psi: torch.Tensor, spec: JetSpec, n: int, wire: int, kind: str,
             angle: torch.Tensor) -> torch.Tensor:
    """A rotation whose angle is a jet (``[C, B]``) on the state jet ``psi``
    (``[C, B, 2^n]``): ``(M psi)' = M psi' + a' M' psi``,
    ``(M psi)'' = M psi'' + 2 a' M' psi' + (a'' M' + a'^2 M'') psi``."""
    m, m1, m2 = rot_derivs(kind, angle[0])  # [B, 2, 2]
    p = apply_1q(psi, n, wire, m)  # M on every channel
    out = [p[0]]
    q0 = apply_1q(psi[0], n, wire, m1)
    a1 = spec.first(angle)[..., None]
    out += list(spec.first(p) + a1.to(CDTYPE) * q0)
    if spec.second:
        r0 = apply_1q(psi[0], n, wire, m2)
        qs = apply_1q(spec.firsts_of_second(psi), n, wire, m1)
        aj = spec.firsts_of_second(angle)[..., None].to(CDTYPE)
        ajj = spec.seconds(angle)[..., None].to(CDTYPE)
        out += list(spec.seconds(p) + 2.0 * aj * qs + ajj * q0 + aj * aj * r0)
    return torch.stack(out)


def jet_z(psi: torch.Tensor, spec: JetSpec, n: int) -> torch.Tensor:
    """``<Z_w>`` of a state jet: ``z = Re <psi|Z|psi>``, ``z' = 2 Re
    <psi'|Z|psi>``, ``z'' = 2 Re <psi''|Z|psi> + 2 Re <psi'|Z|psi'>``."""
    zs = z_signs(n, psi.device)

    def form(a, b):
        return torch.matmul((torch.conj(a) * b).real, zs)

    p0 = psi[0]
    out = [form(p0, p0)[None], 2.0 * form(spec.first(psi), p0)]
    if spec.second:
        f = spec.firsts_of_second(psi)
        out.append(2.0 * form(spec.seconds(psi), p0) + 2.0 * form(f, f))
    return torch.cat(out)


# -- optax's clip and Adam ---------------------------------------------------


B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """optax ``chain(clip_by_global_norm(clip), adam(lr))``: the gradients
    scaled by ``clip / norm`` where the global norm reaches ``clip``; the
    moments, their bias corrections and ``lr * mu_hat / (sqrt(nu_hat) +
    eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor], clip: float):
        self.clip = clip
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
        if float(norm) < self.clip:
            return dict(grads)
        return {k: g * (self.clip / norm).to(g.dtype) for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params, grads, lr: float) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients (what
        the moments took)."""
        g = self.clipped(grads)
        self.count += 1
        bc1, bc2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for k, p in params.items():
            self.mu[k] = B1 * self.mu[k] + (1.0 - B1) * g[k]
            self.nu[k] = B2 * self.nu[k] + (1.0 - B2) * g[k] * g[k]
            p -= lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
        return g


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def row_blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]
