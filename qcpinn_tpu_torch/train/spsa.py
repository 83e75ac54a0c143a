"""SPSA (port of qcpinn_tpu/train/spsa.py): simultaneous-perturbation
stochastic approximation, 2 loss evaluations a step whatever the parameter
count, the reference's hardware-efficient gradient mode
(cg-hqpinn/CG_HQPINN_IBMtest_16q_effective.py:484-512,
hybrid_qpinn_2dcrystal_ibmtest.py:271-294).

- ``spsa_step``: decaying gains a_k = a/k^alpha, c_k = c/k^gamma (the 16q
  pipeline), Rademacher perturbations of every tensor; constant gains are
  alpha = gamma = 0.
- ``spsa_split_step``: SPSA on the quantum tensors, Adam on the classical
  ones (the reference's split update).

The port's parameters are the model's tensors, updated in place under
``no_grad``: ``loss_fn(key)`` evaluates the loss at their current values
(``key`` a ``torch.Generator``, for shot-sampled losses). The step counter
``k`` may be a device tensor, so the decaying gains live inside a captured
CUDA graph; the perturbation is drawn by ``torch.randint`` on the
generator. The loss may be stochastic: SPSA needs only zeroth-order
evaluations, which is why the reference uses it on hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from . import optim

Params = Union[Dict[str, torch.Tensor], Sequence[torch.Tensor]]


@dataclasses.dataclass
class SPSAConfig:
    a: float = 0.1
    c: float = 0.02
    alpha: float = 0.602
    gamma: float = 0.101


def _leaves(params: Params) -> List[torch.Tensor]:
    return list(params.values()) if isinstance(params, dict) else list(params)


def _rademacher_like(key: torch.Generator, leaves: Sequence[torch.Tensor]):
    """+-1 of each tensor's shape and dtype, from ``key``."""
    return [torch.randint(0, 2, tuple(p.shape), generator=key, device=p.device)
            .to(p.dtype) * 2.0 - 1.0 for p in leaves]


def _gains(k, cfg: SPSAConfig, lr_scale):
    kf = k.to(torch.float32) if isinstance(k, torch.Tensor) else float(k)
    # lr_scale lets an outer scheduler (the plateau) modulate the gain on top
    # of the decaying a_k, the role scale_updates plays for Adam
    return lr_scale * cfg.a / (kf**cfg.alpha), cfg.c / (kf**cfg.gamma)


@torch.no_grad()
def _set(leaves, values):
    for p, v in zip(leaves, values):
        p.copy_(v)


def _at(loss_fn, leaves, values, key):
    """``loss_fn(key)`` with the tensors set to ``values``; the loss (or
    ``(loss, aux)``) detached. No backward graph is built: the
    forward-mode operators run under ``no_grad``, the reverse-mode ones
    turn grad on for themselves."""
    _set(leaves, values)
    with torch.no_grad():
        out = loss_fn(key)
    if isinstance(out, tuple):
        return out[0].detach(), {k: v.detach() for k, v in out[1].items()}
    return out.detach()


def _spsa_update(loss_fn, leaves, k, delta, key, cfg, has_aux, lr_scale):
    """The SPSA update of ``leaves`` in place along the perturbation
    ``delta`` (``spsa_step`` draws it); returns the mean loss (and aux)."""
    ak, ck = _gains(k, cfg, lr_scale)
    base = [p.detach().clone() for p in leaves]
    plus = _at(loss_fn, leaves, [p + ck * d for p, d in zip(base, delta)], key)
    minus = _at(loss_fn, leaves, [p - ck * d for p, d in zip(base, delta)], key)
    loss_plus, loss_minus = (plus[0], minus[0]) if has_aux else (plus, minus)
    ghat = (loss_plus - loss_minus) / (2.0 * ck)
    # the reference divides by d elementwise; d in {-1, +1}, so /d == *d
    _set(leaves, [p - ak * ghat * d for p, d in zip(base, delta)])
    mean_loss = (loss_plus + loss_minus) / 2.0
    if has_aux:
        aux = {n: (plus[1][n] + minus[1][n]) / 2.0 for n in plus[1]}
        return mean_loss, aux
    return mean_loss


def spsa_step(
    loss_fn: Callable,
    params: Params,
    k,
    key: torch.Generator,
    cfg: SPSAConfig = SPSAConfig(),
    has_aux: bool = False,
    lr_scale: Union[torch.Tensor, float] = 1.0,
) -> Tuple:
    """One SPSA update of ``params`` (a dict or a sequence of tensors,
    updated in place). ``loss_fn(key) -> scalar`` evaluates the loss at the
    tensors' current values; ``k`` is the 1-based step counter (a number
    or a device tensor). Returns ``(params, mean loss)``, or with
    ``has_aux=True`` (``loss_fn`` returning ``(scalar, aux dict)``)
    ``(params, mean loss, aux)``, aux the mean of the two perturbed
    evaluations: per-term metrics at SPSA's two evaluations a step."""
    leaves = _leaves(params)
    delta = _rademacher_like(key, leaves)
    out = _spsa_update(loss_fn, leaves, k, delta, key, cfg, has_aux, lr_scale)
    return (params, *out) if has_aux else (params, out)


def split_params(params: Dict[str, torch.Tensor], quantum_keys=("q",)):
    """Partition named tensors into (quantum, classical) dicts by the first
    component of each name: the model's quantum weights live under a
    top-level name (DVSolver: ``q``), the boundary the reference draws when
    it hands ``[model.q_layer.weights]`` to SPSA and the rest to Adam
    (cg-hqpinn/CG_HQPINN_IBMtest_16q_effective.py:700-748)."""
    q = {k: v for k, v in params.items() if k.split(".")[0] in quantum_keys}
    c = {k: v for k, v in params.items() if k.split(".")[0] not in quantum_keys}
    return q, c


def _spsa_split_update(loss_fn, params, k, delta, key, cfg, optimizer, opt_state,
                       quantum_keys, has_aux, lr_scale, reduce_grads=None):
    """``spsa_split_step`` along the perturbation ``delta`` of the quantum
    tensors; returns (opt_state, loss[, aux])."""
    ak, ck = _gains(k, cfg, lr_scale)
    q_params, c_params = split_params(params, quantum_keys)
    q_leaves, c_leaves = list(q_params.values()), list(c_params.values())
    base = [p.detach().clone() for p in q_leaves]

    def eval_loss(kk):
        out = loss_fn(kk)
        return out[0] if has_aux else out

    loss_plus = _at(eval_loss, q_leaves, [p + ck * d for p, d in zip(base, delta)], key)
    loss_minus = _at(eval_loss, q_leaves, [p - ck * d for p, d in zip(base, delta)], key)
    ghat = (loss_plus - loss_minus) / (2.0 * ck)

    # the classical backprop step at the unperturbed point, the quantum
    # tensors held fixed (differentiated for the classical tensors only); on
    # a shot-sampled forward the readout carries no gradient already, the
    # reference's hardware behaviour
    _set(q_leaves, base)
    out = loss_fn(key)
    loss0, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss0, c_leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(c_leaves, grads)]
    if reduce_grads is not None:
        grads = reduce_grads(grads)
    updates, opt_state = optimizer.update(grads, opt_state, c_leaves)
    optim.apply_updates(c_leaves, optim.scale_updates(updates, lr_scale))
    _set(q_leaves, [p - ak * ghat * d for p, d in zip(base, delta)])
    loss0 = loss0.detach()
    if has_aux:
        return opt_state, loss0, {n: v.detach() for n, v in aux.items()}
    return opt_state, loss0


def spsa_split_step(
    loss_fn: Callable,
    params: Dict[str, torch.Tensor],
    k,
    key: torch.Generator,
    cfg: SPSAConfig,
    optimizer: optim.GradientTransformation,
    opt_state,
    quantum_keys=("q",),
    has_aux: bool = False,
    lr_scale: Union[torch.Tensor, float] = 1.0,
    reduce_grads: Optional[Callable] = None,
) -> Tuple:
    """The reference's split update (cg-hqpinn/...16q_effective.py:727-748):
    the quantum tensors (first name component in ``quantum_keys``) move by
    SPSA, two loss evaluations perturbing only them, while the classical
    tensors take an ``optimizer`` (Adam) step from a backprop gradient at
    the unperturbed point with the quantum tensors held fixed, the
    reference's third evaluation. ``params`` is named tensors (``dict(
    model.named_parameters())``), updated in place; ``optimizer`` must have
    been ``init``-ed on the classical partition only. Per-term metrics
    (``has_aux``) ride the unperturbed evaluation. ``reduce_grads`` maps the
    classical gradients before the optimizer (a data-parallel step's mean
    over the mesh, ``Mesh.mean_grads``). Returns ``(params, opt_state,
    loss[, aux])``."""
    q_leaves = list(split_params(params, quantum_keys)[0].values())
    delta = _rademacher_like(key, q_leaves)
    out = _spsa_split_update(loss_fn, params, k, delta, key, cfg, optimizer, opt_state,
                             quantum_keys, has_aux, lr_scale, reduce_grads)
    return (params, *out)


def make_spsa_trainer(loss_fn: Callable, cfg: SPSAConfig = SPSAConfig()):
    """``step(params, k, key) -> (params, loss)``: ``spsa_step`` bound to
    ``loss_fn`` and ``cfg``."""

    def step(params, k, key):
        return spsa_step(loss_fn, params, k, key, cfg)

    return step
