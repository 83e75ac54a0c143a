"""Staged training (port of qcpinn_tpu/train/staged.py): classical-only
pretraining, then quantum layer-wise fine-tuning with gradient masking,
adaptive shot scheduling and noise-aware early stopping
(test_hqpinn_cg.py:180-280).

- Stage 1: freeze the quantum block, train the classical sandwich.
- Stage 2: for each quantum layer in REVERSE order (:227): train with every
  gradient masked except that layer's, under shot noise; estimate the
  loss's noise floor sigma from repeated evaluations (:205-210); stop the
  layer when the improvement is under 2 sigma (:266-273); double the shots
  (512 -> ... -> 4096) and go again, converged when the shots run out
  (:275-280).

Stage 2's losses must differentiate through the parameter-shift estimator
(the reference fine-tunes by parameter-shift, test_hqpinn_cg.py:233-254):
the plain shot-sampled readout carries no gradient (``ops/measure.py``), so
a plain ``shots=`` loss would apply zero updates. Build the loss with
:func:`make_hw_data_loss` (or any loss over a solver's ``hw_apply_fn``).

The port trains the model's tensors in place: ``loss_fn(key)`` evaluates
the loss at the model's current parameters, ``key`` a ``torch.Generator``
on the model's device (seeded from ``StagedConfig.seed``) that each
shot-sampled evaluation draws from. The optimizer is ``train/optim.py``'s
Adam (``optax.adam``'s update), stepping every trainable tensor on masked
gradients, so a masked tensor's moments stay zero and it does not move.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from . import optim


@dataclasses.dataclass
class StagedConfig:
    classical_epochs: int = 300
    layer_epochs: int = 40
    lr_classical: float = 1e-3
    lr_quantum: float = 1e-3
    initial_shots: int = 512
    max_shots: int = 4096
    shots_factor: int = 2
    noise_evals: int = 5
    noise_sigma_factor: float = 2.0
    seed: int = 0


def _trainable(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _masked_adam_step(optimizer, loss_fn, params, opt_state, mask, key):
    """One Adam step of ``params`` on the gradients of ``loss_fn(key)``
    times ``mask``; returns (opt_state, loss)."""
    loss = loss_fn(key)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g * m
             for p, g, m in zip(params, grads, mask)]
    updates, opt_state = optimizer.update(grads, opt_state, params)
    optim.apply_updates(params, updates)
    return opt_state, loss.detach()


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def train_classical_only(
    loss_fn: Callable,
    model: nn.Module,
    quantum_key: str = "q",
    cfg: StagedConfig = StagedConfig(),
    logger=None,
) -> Tuple[nn.Module, List[float]]:
    """Stage 1 (:180-199): Adam on every tensor but the quantum ones (first
    name component ``quantum_key``). ``loss_fn(key) -> scalar`` (exact
    mode). The quantum tensors come back bit-equal: checked, not only
    intended."""
    named = _trainable(model)
    params = list(named.values())
    mask = [0.0 if n.split(".")[0] == quantum_key else 1.0 for n in named]
    q_before = {n: p.detach().clone() for n, p in named.items()
                if n.split(".")[0] == quantum_key}
    optimizer = optim.make_optimizer(cfg.lr_classical, schedule="none")
    opt_state = optimizer.init(params)
    key = torch.Generator(device=_device(model)).manual_seed(cfg.seed)
    history = []
    for epoch in range(cfg.classical_epochs):
        opt_state, loss = _masked_adam_step(optimizer, loss_fn, params, opt_state,
                                            mask, key)
        history.append(float(loss))
        if logger is not None and (epoch % 50 == 0 or epoch == cfg.classical_epochs - 1):
            logger.print(f"[classical] epoch {epoch}: loss={history[-1]:.4e}")
    for n, before in q_before.items():
        if not torch.equal(named[n], before):
            raise AssertionError(f"stage 1 moved the quantum tensor {n}")
    return model, history


def make_hw_data_loss(hw_apply_fn: Callable, X: torch.Tensor, Y: torch.Tensor) -> Callable:
    """``make_loss(shots)`` for :func:`train_quantum_layerwise` from a
    solver's hardware-apply factory (``DVSolver.hw_apply_fn``): the losses
    evaluate under shot noise AND differentiate by the parameter-shift
    rules, so the layer-masked quantum gradients are real."""

    def make_loss(shots):
        apply = hw_apply_fn(shots)

        def loss(key):
            return torch.mean((apply(X, key) - Y) ** 2)

        return loss

    return make_loss


@torch.no_grad()
def estimate_loss_noise(
    loss_fn: Callable, key: torch.Generator, n_evals: int = 5
) -> Tuple[float, float]:
    """Empirical (mean, sigma) of the shot-sampled loss over ``n_evals``
    evaluations, each drawing from ``key`` (:205-210)."""
    vals = [float(loss_fn(key)) for _ in range(n_evals)]
    return float(np.mean(vals)), float(np.std(vals))


def _layer_mask(model: nn.Module, quantum_key: str, layer_idx: int) -> List[torch.Tensor]:
    """Gradient mask over the trainable tensors: only quantum layer
    ``layer_idx`` (row ``layer_idx`` of each quantum tensor) trains
    (:241-254)."""
    masks = []
    for n, p in _trainable(model).items():
        m = torch.zeros_like(p)
        if n.split(".")[0] == quantum_key:
            m[layer_idx] = 1.0
        masks.append(m)
    return masks


def train_quantum_layerwise(
    make_loss: Callable[[int], Callable],
    model: nn.Module,
    num_layers: int,
    quantum_key: str = "q",
    cfg: StagedConfig = StagedConfig(),
    logger=None,
) -> Tuple[nn.Module, List[dict]]:
    """Stage 2 (:216-280). ``make_loss(shots)`` returns ``loss_fn(key) ->
    scalar`` under that shot budget. Layers train last-first; per layer the
    shots escalate 512 -> 4096 (x2) with noise-aware early stopping at each
    level. Returns the model and, per layer, each level's shots, sigma,
    starting and best loss and whether it stopped early."""

    def log(msg):
        if logger is not None:
            logger.print(msg)

    params = list(_trainable(model).values())
    device = _device(model)
    report = []
    for layer_idx in reversed(range(num_layers)):
        mask = _layer_mask(model, quantum_key, layer_idx)
        shots = cfg.initial_shots
        layer_log = {"layer": layer_idx, "levels": []}
        while True:
            loss_fn = make_loss(shots)
            optimizer = optim.make_optimizer(cfg.lr_quantum, schedule="none")
            opt_state = optimizer.init(params)
            # one stream a (layer, shot level), as JAX folds its key
            key = torch.Generator(device=device).manual_seed(
                cfg.seed + 100 + layer_idx * 1000 + shots)
            start_mean, sigma = estimate_loss_noise(loss_fn, key, cfg.noise_evals)
            best = start_mean
            stopped_early = False
            for epoch in range(cfg.layer_epochs):
                opt_state, loss = _masked_adam_step(optimizer, loss_fn, params,
                                                    opt_state, mask, key)
                improvement = best - float(loss)
                if improvement > 0:
                    best = float(loss)
                # noise-aware early stop (:266-273): progress must exceed
                # the measured noise floor to count
                if epoch >= 5 and improvement < cfg.noise_sigma_factor * sigma:
                    stopped_early = True
                    break
            layer_log["levels"].append(
                {"shots": shots, "sigma": sigma, "start": start_mean,
                 "best": best, "early_stop": stopped_early})
            log(f"[layerwise] layer {layer_idx} shots={shots}: best={best:.4e} "
                f"sigma={sigma:.2e} early_stop={stopped_early}")
            if shots >= cfg.max_shots:
                break  # the layer converged at the largest shot budget (:275-280)
            shots *= cfg.shots_factor
        report.append(layer_log)
    return model, report
