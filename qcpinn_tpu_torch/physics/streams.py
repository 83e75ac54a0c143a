"""Tangent-stream diffusion residuals (port of
qcpinn_tpu/physics/streams.py).

The circuit U is linear in the state and shared across the batch, so the
input-coordinate derivatives of psi(X) = U . E(a(X)) need no autodiff
through the circuit:

    d psi   = U . dE,    dE  = A_v E,          A_v = -i/2 sum_i v_i X_i
    d^2 psi = U . d2E,   d2E = (A_v^2 + A_w) E
    (v = da/dX_col, w = d2a/dX_col^2;  RX(a) = exp(-i a X / 2))

The primal state and all five derivative streams go through ONE forward of
U as a 6x-wider batch; expectations and their derivatives come back as
bilinear readouts:

    z = <psi|Z|psi>,  dz = 2 Re <dpsi|Z|psi>,
    d2z = 2 Re <d2psi|Z|psi> + 2 <dpsi|Z|dpsi>

The classical encoder and decoder are small; their derivatives use
``torch.func.jvp``, nested for second order.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jvp

from ..models.nn_core import rbf_apply
from ..ops import statevector as sv


def _col_tangent(X: torch.Tensor, col: int) -> torch.Tensor:
    t = torch.zeros_like(X)
    t[:, col] = 1.0
    return t


def _enc_d1(f: Callable, X: torch.Tensor, col: int):
    return jvp(f, (X,), (_col_tangent(X, col),))


def _enc_d2(f: Callable, X: torch.Tensor, col: int):
    tangent = _col_tangent(X, col)

    def g(Xp):
        return jvp(f, (Xp,), (tangent,))

    (a, da), (_, d2a) = jvp(g, (X,), (tangent,))
    return a, da, d2a


def _wire_flips(state: torch.Tensor, n: int) -> torch.Tensor:
    """[n, B, D]: X_i applied to the state for every wire (bit_i flip)."""
    flips = []
    for w in range(n):
        s = state.reshape(state.shape[0], 1 << w, 2, 1 << (n - 1 - w))
        flips.append(torch.flip(s, dims=(2,)).reshape(state.shape))
    return torch.stack(flips, dim=0)


def _a_op(flips: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A_v state = -i/2 sum_i v_i X_i state, from precomputed flips.
    v: [B, n] real."""
    acc = torch.einsum("bi,ibd->bd", v.to(torch.complex64), flips)
    return -0.5j * acc


def _bilinear_z(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Re <a|Z_w|b> for all wires: [B, n]."""
    prod = (torch.conj(a) * b).real.to(torch.float32)
    return prod @ sv.z_sign(n, prod.device)


def circuit_z_streams(
    circuit,
    q_params: torch.Tensor,
    a: torch.Tensor,
    d1: dict,
    d2: dict,
    evolve_fn=None,
    bilinear_fn=None,
) -> Tuple[torch.Tensor, dict, dict]:
    """Given angles a [B, n] and their coordinate derivatives
    (d1[col] = da/dcol, d2[col] = d2a/dcol^2), return (z, dz[col],
    d2z[col]) with ONE batched circuit evolution. d2's keys must be a
    subset of d1's. ``bilinear_fn(x, y) -> Re <x|Z_w|y>`` reads the evolved
    streams: an amp-sharded engine's ``evolve`` returns this rank's
    amplitude block and its ``bilinear_z`` sums the blocks' shares over the
    mesh, so the 6x-wide batch stays sharded."""
    n = circuit.n
    b = a.shape[0]
    E = circuit.prepare(a)  # [B, D]
    # prepare() encodes RX(s*a); the stream derivatives are w.r.t. the
    # rotation angle, so the scale enters both tangents
    s_in = circuit.input_scale
    if s_in != 1.0:
        d1 = {k: v * s_in for k, v in d1.items()}
        d2 = {k: v * s_in for k, v in d2.items()}
    flips = _wire_flips(E, n)

    streams = [E]
    index = {"0": 0}
    d1_states = {}
    for col, v in d1.items():
        s = _a_op(flips, v)
        d1_states[col] = s
        index[f"d1_{col}"] = len(streams)
        streams.append(s)
    for col, w in d2.items():
        s2 = _a_op(_wire_flips(d1_states[col], n), d1[col]) + _a_op(flips, w)
        index[f"d2_{col}"] = len(streams)
        streams.append(s2)

    stacked = torch.cat(streams, dim=0)  # [K*B, D]
    if evolve_fn is None:
        evolve_fn = circuit.evolve
    evolved = evolve_fn(q_params, stacked)

    def stream(tag):
        i = index[tag]
        return evolved[i * b : (i + 1) * b]

    if bilinear_fn is None:
        def bilinear_fn(x, y):
            return _bilinear_z(x, y, n)

    psi0 = stream("0")
    z = bilinear_fn(psi0, psi0)
    dz = {col: 2.0 * bilinear_fn(stream(f"d1_{col}"), psi0) for col in d1}
    d2z = {}
    for col in d2:
        psi_c = stream(f"d1_{col}")
        d2z[col] = 2.0 * bilinear_fn(stream(f"d2_{col}"), psi0) + 2.0 * bilinear_fn(
            psi_c, psi_c)
    return z, dz, d2z


def dv_diffusion_residual_streams(
    model,
    X: torch.Tensor,
    sigma_t: float = 1.0,
    sigma_x: float = 1.0,
    sigma_y: float = 1.0,
    D: float = 0.01,
    v_x: float = 1.0,
    v_y: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convection-diffusion (u, residual) for a DVSolver or DVFourierSolver
    via tangent streams. X = [t, x, y]. ``model.encode`` gives the angles
    in its first n columns and the head's extra classical features after
    them (none for a DVSolver: the extra slices are then [B, 0] and the
    head sees z alone). The evolution is the model's engine
    (``model.qblock.evolve``)."""
    n = model.circuit.n
    enc0, enc_t = _enc_d1(model.encode, X, 0)
    _, enc_x, enc_xx = _enc_d2(model.encode, X, 1)
    _, enc_y, enc_yy = _enc_d2(model.encode, X, 2)

    a = enc0[:, :n]
    d1 = {"t": enc_t[:, :n], "x": enc_x[:, :n], "y": enc_y[:, :n]}
    d2 = {"x": enc_xx[:, :n], "y": enc_yy[:, :n]}
    z, dz, d2z = circuit_z_streams(
        model.circuit, model.q, a, d1, d2, model.qblock.evolve,
        getattr(model.qblock, "bilinear_z", None),
    )

    # decoder chain rule via nested jvp over the (z, extra) feature space
    f0 = torch.cat([z, enc0[:, n:]], dim=-1)
    g_t = torch.cat([dz["t"], enc_t[:, n:]], dim=-1)
    g_x = torch.cat([dz["x"], enc_x[:, n:]], dim=-1)
    g_y = torch.cat([dz["y"], enc_y[:, n:]], dim=-1)
    h_x = torch.cat([d2z["x"], enc_xx[:, n:]], dim=-1)
    h_y = torch.cat([d2z["y"], enc_yy[:, n:]], dim=-1)

    u, u_t = jvp(model.head, (f0,), (g_t,))

    def second(gcol, hcol):
        def inner(f):
            return jvp(model.head, (f,), (gcol,))

        # jvp of `inner` at f0 along g gives (J g, H[g, g]); the remaining
        # first-order term J h is one more jvp
        (_, du), (_, curv) = jvp(inner, (f0,), (gcol,))
        _, jh = jvp(model.head, (f0,), (hcol,))
        return du, curv + jh

    u_x, u_xx = second(g_x, h_x)
    u_y, u_yy = second(g_y, h_y)

    if getattr(model, "rbf", None) is not None:
        # additive RBF head (models/dv_fourier.py): a direct function of X,
        # so its streams are ordinary nested jvps, no circuit involved
        def rbf_fn(Xp):
            return rbf_apply(model.rbf, Xp)

        r0, r_t = _enc_d1(rbf_fn, X, 0)
        _, r_x, r_xx = _enc_d2(rbf_fn, X, 1)
        _, r_y, r_yy = _enc_d2(rbf_fn, X, 2)
        u, u_t = u + r0, u_t + r_t
        u_x, u_y = u_x + r_x, u_y + r_y
        u_xx, u_yy = u_xx + r_xx, u_yy + r_yy

    residual = (
        u_t[:, 0] / sigma_t
        + v_x * u_x[:, 0] / sigma_x
        + v_y * u_y[:, 0] / sigma_y
        - D * (u_xx[:, 0] / sigma_x**2 + u_yy[:, 0] / sigma_y**2)
    )
    return u[:, 0:1], residual[:, None]
