"""Plain reference of the 16-qubit Czochralski hybrid PINN's pretrain step.

Written from the reference model (hybrid_testing/CG_HQPINN_IBMtest_16qubits.py:
the model :52-147, the circuit :217-235, the melt's residuals :322-397, the
EMA weighting :408-422 and :510-513, the training loop :471-540) in plain
PyTorch. It imports nothing of the program: the melt data is parsed from
the raw COMSOL export here, the circuit is applied gate by gate, and the
derivatives along r and z come from second-order forward jets
(``plain.py``), not from nested ``jvp``.

  [r, z] -> [x, sin(2 pi x B), cos(2 pi x B)] -> L T L T      (coord_proj)
         -> h = tanh(h + L T L (h)) twice                      (res1, res2)
  angles = pi tanh(L T L (h))                                  (to_quantum)
  circuit: RY(angle_w) on |0..0>; per layer l: RZ(angle_{(w+l)%n} / 2) on
           wire w, Rot(q[l, w]) on wire w, CZ on (0,1),(2,3),..., then on
           (1,2),(3,4),..., then on (n-1, 0); <Z_w> of every wire
  features = [tanh(L(h)), LayerNorm(<Z>), r, z]
  out = L T L T L (features); u_r and u_theta times r

One step: the loss over a batch (data MSE plus the EMA-weighted physics
terms), its gradient, clip by global norm 1 and Adam at the epoch's learning
rate. The physics weight divides by the mean EMA ratio of the physics terms,
which needs the whole batch's terms: so a step is two passes over blocks of
rows, one without gradients for the terms, one for the gradient.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from plain import (Adam, JetSpec, apply_1q, apply_cz, input_jet, jet_cos, jet_gate,
                   jet_layernorm, jet_linear, jet_mul, jet_sin, jet_tanh, jet_z, leaf_norms,
                   rot, row_blocks, zero_state)

PHYS_KEYS = ("cont", "mom_r", "mom_z", "swirl", "energy")
SPEC = JetSpec(nd=2, second=(0, 1))  # r, z; r_rr, z_zz


def load_melt(path: str):
    """The COMSOL export as the reference reads it: columns r, z, u, w,
    vtheta, p, T at [0, 1, 4, 5, 6, 7, 8]; lengths over the largest |r|,
    |z|, velocities over the largest |u|, |w|, |vtheta|, pressure over the
    largest |p|, temperature min-max; pressure_coeff = p_scale / V^2.
    Returns (X [N, 2], Y [N, 5], pressure_coeff)."""
    data = np.loadtxt(path, comments="%", dtype=np.float64)
    r, z, u, w, vt, p, T = (data[:, i] for i in (0, 1, 4, 5, 6, 7, 8))
    length = max(np.abs(r).max(), np.abs(z).max(), 1e-12)
    vel = max(np.abs(u).max(), np.abs(w).max(), np.abs(vt).max(), 1e-12)
    pres = max(np.abs(p).max(), 1e-12)
    tspan = max(T.max() - T.min(), 1e-12)
    X = np.stack([r / length, z / length], 1).astype(np.float32)
    Y = np.stack([u / vel, w / vel, vt / vel, p / pres, (T - T.min()) / tspan], 1)
    return X, Y.astype(np.float32), pres / max(vel ** 2, 1e-12)


def circuit_gates(n: int, layers: int):
    """The circuit as a gate list, for the gate-level operation count:
    (kind, wires) with kind one of 1q (a dense 2x2), diag (a one-qubit
    phase), cz."""
    gates = [("1q", (w,)) for w in range(n)]  # RY encoding
    for _ in range(layers):
        gates += [("diag", (w,)) for w in range(n)]  # the reupload RZ
        gates += [("1q", (w,)) for w in range(n)]  # Rot
        gates += [("cz", p) for p in cz_pairs(n)]
    return gates


def cz_pairs(n: int):
    return ([(i, i + 1) for i in range(0, n - 1, 2)] + [(i, i + 1) for i in range(1, n - 1, 2)]
            + [(n - 1, 0)])


def mlp_dims(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every MLP of the model by name, as (in, ..., out): the widths that
    the operation count takes and the program's model is held to."""
    n, w = cfg["n_qubits"], cfg["trunk_width"]
    f = 2 * cfg["fourier_features"]
    dims = {"coord_proj": (2 + f, w, w)}
    dims.update({f"res{i + 1}": (w, w, w) for i in range(cfg["res_blocks"])})
    skip = cfg["classical_skip"]
    dims.update({"to_quantum": (w, cfg["to_quantum"], n), "classical_skip": (w, skip),
                 "post": (skip + n + 2, *cfg["post"])})
    return dims


class Model:
    """The forward pass of a batch's jets from the handed weights (names
    as the benchmark hands them: ``coord_proj.0.weight`` [out, in], ...)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor]):
        self.n, self.layers = cfg["n_qubits"], cfg["n_layers"]
        self.res = [f"res{i + 1}" for i in range(cfg["res_blocks"])]
        self.p = params

    def _lin(self, name, t):
        return jet_linear(t, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

    def _mlp(self, name, count, t, spec):
        for i in range(count):
            t = self._lin(f"{name}.{i}", t)
            if i < count - 1:
                t = jet_tanh(t, spec)
        return t

    def circuit(self, angles: torch.Tensor, spec: JetSpec) -> torch.Tensor:
        """<Z_w> ``[C, B, n]`` of the circuit on the angle jet ``[C, B, n]``."""
        n, q = self.n, self.p["q"]
        psi = zero_state((spec.channels, angles.shape[1]), n, angles.device)
        psi[1:] = 0.0  # |0..0> does not move with the input
        for w in range(n):
            psi = jet_gate(psi, spec, n, w, "ry", angles[:, :, w])
        for layer in range(self.layers):
            for w in range(n):
                psi = jet_gate(psi, spec, n, w, "rz", 0.5 * angles[:, :, (w + layer) % n])
            for w in range(n):
                psi = apply_1q(psi, n, w, rot(q[layer, w, 0], q[layer, w, 1], q[layer, w, 2]))
            for a, b in cz_pairs(n):
                psi = apply_cz(psi, n, a, b)
        return jet_z(psi, spec, n)

    def __call__(self, x: torch.Tensor, spec: JetSpec = SPEC) -> torch.Tensor:
        """The output jet ``[C, B, 5]`` at points ``x [B, 2]``."""
        xj = input_jet(x, spec) if spec.nd else x[None]
        proj = 2.0 * math.pi * torch.matmul(xj, self.p["B"])
        h = torch.cat([xj, jet_sin(proj, spec), jet_cos(proj, spec)], dim=-1)
        h = jet_tanh(self._mlp("coord_proj", 2, h, spec), spec)
        for res in self.res:
            h = jet_tanh(h + self._mlp(res, 2, h, spec), spec)
        angles = math.pi * jet_tanh(self._mlp("to_quantum", 2, h, spec), spec)
        z = self.circuit(angles, spec)
        skip = jet_tanh(self._lin("classical_skip.0", h), spec)
        zn = jet_layernorm(z, spec, self.p["q_norm.gamma"], self.p["q_norm.beta"])
        raw = self._mlp("post", 3, torch.cat([skip, zn, xj], dim=-1), spec)
        r = xj[..., 0:1]
        return torch.cat([jet_mul(r, raw[..., 0:1], spec), raw[..., 1:2],
                          jet_mul(r, raw[..., 2:3], spec), raw[..., 3:5]], dim=-1)


def melt_residuals(jet: torch.Tensor, x: torch.Tensor, pc: float, re: float, pr: float,
                   gr: float) -> Dict[str, torch.Tensor]:
    """The five residuals (per row) of the nondimensional steady
    axisymmetric Navier-Stokes and energy equations, from the output jet
    (channels: value, d/dr, d/dz, d2/dr2, d2/dz2)."""
    f, fr, fz, frr, fzz = jet
    u_r, u_z, u_t, T = f[:, 0], f[:, 1], f[:, 2], f[:, 4]
    r = torch.clamp(x[:, 0], min=1e-4)
    cont = fr[:, 0] + u_r / r + fz[:, 1]
    mom_r = (u_r * fr[:, 0] + u_z * fz[:, 0] - u_t ** 2 / r + pc * fr[:, 3]
             - (frr[:, 0] + fr[:, 0] / r - u_r / r ** 2 + fzz[:, 0]) / re)
    mom_z = (u_r * fr[:, 1] + u_z * fz[:, 1] + pc * fz[:, 3]
             - (frr[:, 1] + fr[:, 1] / r + fzz[:, 1]) / re - gr / re ** 2 * T)
    swirl = (u_r * fr[:, 2] + u_z * fz[:, 2] + u_r * u_t / r
             - (frr[:, 2] + fr[:, 2] / r - u_t / r ** 2 + fzz[:, 2]) / re)
    energy = u_r * fr[:, 4] + u_z * fz[:, 4] - (frr[:, 4] + fr[:, 4] / r + fzz[:, 4]) / (pr * re)
    return dict(zip(PHYS_KEYS, (cont, mom_r, mom_z, swirl, energy)))


def recipe(cfg: dict, traffic: dict) -> dict:
    """The step's settings at the traffic's epoch: the cosine learning rate
    (computed in float32, as the reference's optax schedule does) and the
    physics weight past its warm-up and ramp."""
    e = float(traffic["epoch"])
    c = np.cos(np.float32(math.pi * e / max(cfg["epochs"], 1)))
    lr = float(np.float32(cfg["lr"] * 0.5) * (np.float32(1.0) + c))
    ramp = min(max((e - cfg["physics_warmup"]) / max(cfg["physics_ramp"], 1), 0.0), 1.0)
    return {"lr": lr, "physics_weight": float(np.float32(cfg["physics_weight"] * ramp)),
            "ema_beta": cfg["ema_beta"], "clip": cfg["clip"]}


class Pretrain:
    """The pretrain steps on handed weights: ``step(x, y)`` takes one and
    returns its total loss; ``adam.mu`` and the parameters are its state."""

    def __init__(self, cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor],
                 pressure_coeff: float, device, rows: int):
        self.cfg, self.t = cfg, recipe(cfg, traffic)
        self.pc = pressure_coeff
        self.frozen = {"B": weights["B"].to(device)}
        self.params = {k: v.detach().to(device).clone().requires_grad_(True)
                       for k, v in weights.items() if k != "B"}
        self.adam = Adam(self.params, clip=self.t["clip"])
        self.ema = {k: 1.0 for k in ("data",) + PHYS_KEYS}
        self.rows = rows
        self.grad1 = None

    def _model(self):
        return Model(self.cfg, {**self.params, **self.frozen})

    def _terms(self, x, y, model):
        jet = model(x)
        res = melt_residuals(jet, x, self.pc, self.cfg["re"], self.cfg["pr"], self.cfg["gr"])
        sq = {k: torch.sum(v ** 2) for k, v in res.items()}
        sq["data"] = torch.sum((jet[0] - y) ** 2)
        return sq

    def step(self, x: torch.Tensor, y: torch.Tensor) -> float:
        b, t = x.shape[0], self.t
        beta = t["ema_beta"]
        model = self._model()
        with torch.no_grad():
            sums = {k: 0.0 for k in ("data",) + PHYS_KEYS}
            for blk in row_blocks(b, self.rows):
                for k, v in self._terms(x[blk], y[blk], model).items():
                    sums[k] += float(v)
        terms = {k: sums[k] / (b if k in PHYS_KEYS else b * y.shape[1]) for k in sums}
        avg = max(sum(terms.values()) / len(terms), 1e-12)
        self.ema = {k: beta * self.ema[k] + (1.0 - beta) * terms[k] / avg for k in terms}
        mean_w = max(sum(self.ema[k] for k in PHYS_KEYS) / len(PHYS_KEYS), 1e-12)
        phys_total = sum(terms[k] for k in PHYS_KEYS)
        scale = t["physics_weight"] / mean_w
        total = terms["data"] + scale * phys_total
        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        for blk in row_blocks(b, self.rows):
            sq = self._terms(x[blk], y[blk], model)
            part = (sq["data"] / (b * y.shape[1])
                    + scale * sum(sq[k] for k in PHYS_KEYS) / b)
            g = torch.autograd.grad(part, list(self.params.values()), allow_unused=True)
            for k, gi in zip(self.params, g):
                if gi is not None:
                    grads[k] += gi
        clipped = self.adam.step(self.params, grads, t["lr"])
        if self.grad1 is None:
            self.grad1 = leaf_norms(clipped)
        return total


def follow(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor], batches, data_path: str,
           device, rows: int = 32) -> dict:
    """The reference's readings over the handed batches (row indices into
    the melt data, one array a step): each step's loss, the first step's
    clipped gradient and the change of each parameter over all the steps,
    by leaf norms."""
    X, Y, pc = load_melt(data_path)
    X = torch.as_tensor(X, device=device)
    Y = torch.as_tensor(Y, device=device)
    run = Pretrain(cfg, traffic, weights, pc, device, rows)
    start = {k: v.detach().clone() for k, v in run.params.items()}
    losses = []
    for idx in batches:
        idx = torch.as_tensor(np.asarray(idx), device=device)
        losses.append(run.step(X[idx], Y[idx]))
    change = {k: run.params[k].detach() - start[k] for k in start}
    return {"losses": losses, "grad1": run.grad1, "change": leaf_norms(change)}
