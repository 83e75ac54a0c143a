"""Parameter-shift gradients (port of qcpinn_tpu/train/hardware_grad.py): the
hardware-fidelity gradient path.

On a QPU the reference differentiates a circuit by evaluating it at
shifted parameters (diff_method="parameter-shift", nn/DVQuantumLayer.py:140,
CG_HQPINN_IBMtest_16qubits.py:557): 2 evaluations a rotation parameter, 4
a controlled rotation. Here the same estimator runs against the
shot-sampled engine, as a ``torch.autograd.Function`` around
``DVCircuit.apply``, so it composes with ordinary autograd through the
classical layers.

Shift rules:
- rx/ry/rz/ps/rot components (generator eigenvalue gap 1):
    f'(t) = [f(t + pi/2) - f(t - pi/2)] / 2
- crx/cry/crz (frequencies {1/2, 1}): the four-term rule
    f'(t) = c+ [f(t+pi/2) - f(t-pi/2)] - c- [f(t+3pi/2) - f(t-3pi/2)],
    c+- = (sqrt(2) +- 1) / (4 sqrt(2))
- angle-encoded inputs RX(x_i): the two-term rule a feature.

The Czochralski data-reuploading circuit (``models/czochralski.py``
``CzQuantumLayer``) has rules of its own (:func:`make_hw_apply_cz`): its
Rot weights are all two-term, and a feature occurs once as the RY encoding
and once a layer as a reupload RZ of half its value.

The backward runs every shifted evaluation of the parameters in one
batched call (``torch.func.vmap`` over ``DVCircuit.apply``, the shifted
parameter vectors stacked on a leading axis) and every shifted evaluation
of the inputs in another (the shifted inputs stacked into the batch). With
``shots`` each shifted evaluation draws its own shots: one draw of shape
``[K, B, n]`` from the step's generator, the law of JAX's folded keys (each
evaluation a separate hardware job).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..ops import measure
from ..ops.circuit import DVCircuit
from ..ops.gates import untransformed

TWO_TERM = {"rx", "ry", "rz", "ps", "rot"}
FOUR_TERM = {"crx", "cry", "crz"}
_C_PLUS = (math.sqrt(2.0) + 1.0) / (4.0 * math.sqrt(2.0))
_C_MINUS = (math.sqrt(2.0) - 1.0) / (4.0 * math.sqrt(2.0))


def _param_kinds(circuit: DVCircuit) -> List[str]:
    """Gate kind of each per-layer parameter index (from the unfused
    program: fusion does not change which gate owns a parameter)."""
    kinds = [None] * circuit.params_per_layer
    for op in circuit.program_raw:
        for j in op.pidx:
            kinds[j] = op.kind
    if any(k is None for k in kinds):
        raise ValueError("program has unused parameter slots")
    return kinds


class _ShiftRules:
    """The static shift tables of one circuit. Rows of the parameter
    table, in order: the two-term parameters shifted by +pi/2, then by
    -pi/2; the four-term ones by +pi/2, -pi/2, +3pi/2, -3pi/2."""

    def __init__(self, circuit: DVCircuit, shots: Optional[int], noise):
        self.circuit, self.shots = circuit, shots
        self.noise = noise.bind(circuit) if noise is not None else None
        kinds = _param_kinds(circuit)
        L, P = circuit.layers, circuit.params_per_layer
        self.two = [l * P + j for l in range(L) for j, k in enumerate(kinds)
                    if k in TWO_TERM]
        self.four = [l * P + j for l in range(L) for j, k in enumerate(kinds)
                     if k in FOUR_TERM]
        rows = [(i, s) for s in (np.pi / 2, -np.pi / 2) for i in self.two]
        rows += [(i, s) for s in (np.pi / 2, -np.pi / 2, 3 * np.pi / 2, -3 * np.pi / 2)
                 for i in self.four]
        table = np.zeros((len(rows), L * P), dtype=np.float32)
        for r, (i, s) in enumerate(rows):
            table[r, i] = s
        self.table = table
        self._consts = {}

    def constants(self, device):
        """(shift table, two-term indices, four-term indices) on ``device``,
        built once outside any transform."""
        if device not in self._consts:
            with untransformed():
                self._consts[device] = (
                    torch.as_tensor(self.table, device=device),
                    torch.as_tensor(self.two, dtype=torch.long, device=device),
                    torch.as_tensor(self.four, dtype=torch.long, device=device))
        return self._consts[device]

    def exact(self, params, x):
        c = self.circuit
        return c.apply(params.reshape(c.layers, c.params_per_layer), x, noise=self.noise)

    def read(self, z, key):
        if self.shots is None:
            return z
        return measure.sample_z_from_expectations(z, self.shots, key)

    def evaluate(self, params, x, key):
        measure.check_key(self.shots, key)
        return self.read(self.exact(params, x), key)

    def vjp(self, params, x, key, g):
        """(d params, d x) of ``sum(apply(params, x) * g)`` by the shift
        rules."""
        table, two, four = self.constants(params.device)
        flat = params.reshape(-1)
        d_flat = torch.zeros_like(flat)
        if table.shape[0]:
            z = self.read(torch.func.vmap(lambda p: self.exact(p, x))(flat[None] + table), key)
            t, q = len(self.two), len(self.four)
            if t:
                jac = (z[:t] - z[t : 2 * t]) / 2.0
                d_flat = d_flat.index_put((two,), torch.einsum("kbn,bn->k", jac, g))
            if q:
                p1, m1, p2, m2 = z[2 * t :].reshape(4, q, *z.shape[1:])
                jac = _C_PLUS * (p1 - m1) - _C_MINUS * (p2 - m2)
                d_flat = d_flat.index_put((four,), torch.einsum("kbn,bn->k", jac, g))
        # every feature shifted by +-pi/2 on its own, stacked into the batch:
        # shifting feature i of sample b moves row b only
        b, f = x.shape
        eye = torch.eye(f, dtype=x.dtype, device=x.device) * (np.pi / 2)
        shifted = torch.cat([x[None] + eye[:, None, :], x[None] - eye[:, None, :]])
        zx = self.exact(params, shifted.reshape(2 * f * b, f)).reshape(2 * f, b, -1)
        zx = self.read(zx, key)
        jac_x = (zx[:f] - zx[f:]) / 2.0
        d_x = torch.einsum("fbn,bn->bf", jac_x, g)
        return d_flat.reshape(params.shape), d_x


class _ParameterShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, x, key, rules):
        ctx.save_for_backward(params, x)
        ctx.key, ctx.rules = key, rules
        return rules.evaluate(params, x, key)

    @staticmethod
    def backward(ctx, g):
        params, x = ctx.saved_tensors
        d_params, d_x = ctx.rules.vjp(params, x, ctx.key, g)
        return d_params, d_x, None, None


def make_hw_apply(circuit: DVCircuit, shots: Optional[int], noise=None):
    """``hw_apply(params, x, key) -> [B, n]`` with the parameter-shift
    backward. ``key`` is a ``torch.Generator`` (unused with ``shots=None``,
    which gives the exact estimator through the same code path, the check
    of the shift rules against autograd). ``noise`` (a
    ``measure.NoiseModel``) acts inside every evaluation: the rules stay
    exact for the noisy expectation, the channel being a
    parameter-independent linear map of <Z>."""
    if circuit.encoding != "angle":
        raise ValueError("parameter-shift input gradients need angle encoding")
    rules = _ShiftRules(circuit, shots, noise)

    def hw_apply(params: torch.Tensor, x: torch.Tensor,
                 key: Optional[torch.Generator] = None) -> torch.Tensor:
        return _ParameterShift.apply(params, x, key, rules)

    return hw_apply


def evals_per_step(circuit: DVCircuit) -> int:
    """Circuit executions a step (readme.md:166-171, cg-hqpinn/...:711-718):
    the forward, 2 a two-term parameter, 4 a four-term parameter and 2 an
    input feature."""
    kinds = _param_kinds(circuit)
    per_layer = sum(2 if k in TWO_TERM else 4 for k in kinds)
    return 1 + circuit.layers * per_layer + 2 * circuit.n


class _CzShiftRules:
    """The shift table of the Czochralski circuit: one row a shifted
    evaluation, (weight offsets [L n 3], encoding offsets [n], reupload
    offsets [L n]). Rows, in order: each Rot weight shifted by +pi/2, then
    by -pi/2; each encoding RY(x_j) by +pi/2, then -pi/2; each reupload
    occurrence m = l n + j (feature j in layer l, on wire (j - l) mod n) by
    +pi/2, then -pi/2."""

    def __init__(self, qlayer, shots: Optional[int], noise, chunk: int):
        self.qlayer, self.shots, self.chunk = qlayer, shots, chunk
        self.noise = noise.bind(qlayer) if noise is not None else None
        L, n = qlayer.layers, qlayer.n
        k, ln = L * n * 3, L * n
        half = np.float32(np.pi / 2)
        w_tab = np.zeros((2 * k, k), np.float32)
        w_tab[np.arange(k), np.arange(k)] = half
        w_tab[k + np.arange(k), np.arange(k)] = -half
        e_tab = np.zeros((2 * n, n), np.float32)
        e_tab[np.arange(n), np.arange(n)] = half
        e_tab[n + np.arange(n), np.arange(n)] = -half
        m = np.arange(ln)
        wire = (m // n) * n + (m % n - m // n) % n  # flat (layer, wire) of occurrence m
        r_tab = np.zeros((2 * ln, ln), np.float32)
        r_tab[m, wire] = half
        r_tab[ln + m, wire] = -half
        rows = 2 * k + 2 * n + 2 * ln
        self.tables = (np.concatenate([w_tab, np.zeros((rows - 2 * k, k), np.float32)]),
                       np.concatenate([np.zeros((2 * k, n), np.float32), e_tab,
                                       np.zeros((2 * ln, n), np.float32)]),
                       np.concatenate([np.zeros((2 * k + 2 * n, ln), np.float32), r_tab]))
        self.feature = m % n  # the feature each reupload occurrence reads
        self._consts = {}

    def constants(self, device):
        """(weight, encoding, reupload offset tables, feature index) on
        ``device``, built once outside any transform."""
        if device not in self._consts:
            with untransformed():
                self._consts[device] = (
                    *(torch.as_tensor(t, device=device) for t in self.tables),
                    torch.as_tensor(self.feature, dtype=torch.long, device=device))
        return self._consts[device]

    def exact(self, weights, x, enc_off=None, reup_off=None):
        return self.qlayer.apply(weights, x, noise=self.noise, enc_off=enc_off,
                                 reup_off=reup_off)

    def read(self, z, key):
        if self.shots is None:
            return z
        return measure.sample_z_from_expectations(z, self.shots, key)

    def evaluate(self, weights, x, key):
        measure.check_key(self.shots, key)
        return self.read(self.exact(weights, x), key)

    def vjp(self, weights, x, key, g):
        """(d weights, d x) of ``sum(apply(weights, x) * g)`` by the shift
        rules: every shifted evaluation under ``torch.func.vmap``, in chunks
        of ``chunk`` rows (peak memory one chunk's circuits), then one
        ``[rows, B, n]`` shot draw (each evaluation its own shots)."""
        w_tab, e_tab, r_tab, feature = self.constants(weights.device)
        L, n = self.qlayer.layers, self.qlayer.n

        def one(dw, de, dr):
            return self.exact(weights + dw.reshape(L, n, 3), x, de, dr.reshape(L, n))

        shifted = torch.func.vmap(one)
        z = torch.cat([shifted(w_tab[i:i + self.chunk], e_tab[i:i + self.chunk],
                               r_tab[i:i + self.chunk])
                       for i in range(0, w_tab.shape[0], self.chunk)])
        z = self.read(z, key)
        k, ln = L * n * 3, L * n
        jac_w = (z[:k] - z[k:2 * k]) / 2.0
        d_w = torch.einsum("kbn,bn->k", jac_w, g).reshape(L, n, 3)
        enc = z[2 * k:2 * k + 2 * n]
        reup = z[2 * k + 2 * n:]
        jac_x = (enc[:n] - enc[n:]) / 2.0
        # the reupload angle is x_j / 2: its inner derivative adds the 1/2
        jac_x = jac_x.index_add(0, feature, 0.5 * ((reup[:ln] - reup[ln:]) / 2.0))
        d_x = torch.einsum("fbn,bn->bf", jac_x, g)
        return d_w, d_x


def make_hw_apply_cz(qlayer, shots: Optional[int], noise=None, chunk: int = 32):
    """Parameter-shift estimator of the Czochralski data-reuploading
    circuit (``models/czochralski.py`` ``CzQuantumLayer``): ``hw_apply(
    weights, x, key) -> [B, n]`` with the shift rules as its backward, the
    reference's full-scope IBM fine-tuning QNode
    (CG_HQPINN_IBMtest_16qubits.py:557, diff_method="parameter-shift").

    Shift rules:
    - Rot weights (L, n, 3): all two-term (gap-1 generators), shift pi/2.
    - inputs: feature j occurs once as the RY(x_j) encoding (two-term) and
      once per layer l as the reupload RZ(0.5 x_j) on wire (j - l) mod n;
      the product rule sums a two-term estimate an occurrence, the
      reupload's inner derivative adding the factor 1/2.

    Every shifted evaluation draws fresh shots (separate hardware jobs),
    from ``key``, a ``torch.Generator``. ``shots=None`` gives the exact
    estimator through the same code path, the check against autograd."""
    rules = _CzShiftRules(qlayer, shots, noise, chunk)

    def hw_apply(weights: torch.Tensor, x: torch.Tensor,
                 key: Optional[torch.Generator] = None) -> torch.Tensor:
        return _ParameterShift.apply(weights, x, key, rules)

    return hw_apply


def evals_per_step_cz(qlayer) -> int:
    """Circuit executions a full-scope Cz finetune step: the forward, 2 a
    Rot component, 2 an encoding feature and 2 a reupload occurrence (289
    at 16 qubits and 2 layers)."""
    L, n = qlayer.layers, qlayer.n
    return 1 + 2 * (L * n * 3) + 2 * n + 2 * (L * n)
