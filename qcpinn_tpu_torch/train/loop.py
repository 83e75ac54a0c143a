"""Physics-informed train step (port of qcpinn_tpu/train/loop.py:
``TermSpec`` and ``make_train_step`` in backprop mode).

One step: sample every term's points -> forward -> PDE residual (the
tangent-stream ``residual_fn`` or a generic ``operator``) -> weighted MSE
-> grad -> clip + Adam (``train/optim.py``) -> plateau scheduler. The JAX
``lax.scan`` over a chunk of steps becomes a plain eager loop; the host
waits on the device only when the caller reads a metric.

Not ported yet: SPSA gradient modes, shot-sampled value terms and the
adaptive loss balancers (ROADMAP queue 1 item 9), and the device-mesh data
axis (item 13). Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from . import losses as L
from . import optim


@dataclasses.dataclass(frozen=True)
class TermSpec:
    """One loss term: where its points come from, how many, its weight, and
    whether the model output ('value') or the PDE residual ('residual') is
    matched to the sampler's target."""

    sampler: object  # has sample(generator, n) -> (X, y)
    weight: float
    batch: int
    kind: str = "value"  # value | residual


def make_train_step(
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    operator: Callable,
    terms: Dict[str, TermSpec],
    optimizer: optim.GradientTransformation,
    config,
    mesh=None,
    residual_fn: Optional[Callable] = None,
    shots_apply: Optional[Callable] = None,
    fuse_value_terms: bool = False,
    balancer: str = "none",
):
    """Build (step_fn, run_steps).

    ``model_apply(X) -> [B, out]`` runs the model with its current
    parameters; ``operator(apply, X) -> (u, residual)``. When
    ``residual_fn(X) -> (u, residual)`` is given it replaces the operator
    for 'residual' terms (the tangent-stream residuals). With
    ``fuse_value_terms`` every value term goes through ONE ``model_apply``
    on the concatenated points.

    ``step_fn(params, opt_state, sched, generator) -> (opt_state, sched,
    metrics)`` updates ``params`` (the model's trainable tensors) in place;
    ``run_steps(..., n_steps)`` runs that many steps and returns the metric
    trace stacked over steps. Nothing synchronises with the host."""
    if balancer not in ("none", "ema", "uncertainty"):
        raise ValueError(
            f"unknown balancer {balancer!r}; have none, ema, uncertainty"
        )
    if balancer != "none":
        raise NotImplementedError(
            "adaptive loss balancers are not yet ported (ROADMAP queue 1 item 9)"
        )
    if config.gradient_mode != "backprop":
        raise NotImplementedError(
            f"gradient_mode {config.gradient_mode!r} is not yet ported "
            "(ROADMAP queue 1 item 9)"
        )
    if shots_apply is not None:
        raise NotImplementedError(
            "shot-sampled value terms are not yet ported (ROADMAP queue 1 item 9)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "the device-mesh data axis is not yet ported (ROADMAP queue 1 item 13)"
        )
    names = tuple(terms.keys())
    use_plateau = config.scheduler == "plateau"
    value_names = tuple(n for n in names if terms[n].kind != "residual")
    fuse_values = fuse_value_terms and len(value_names) > 1

    def loss_fn(batches):
        per_term = {}
        for name in names:
            if fuse_values and name in value_names:
                continue
            X, y = batches[name]
            if terms[name].kind == "residual":
                if residual_fn is not None:
                    _, pred = residual_fn(X)
                else:
                    _, pred = operator(model_apply, X)
            else:
                pred = model_apply(X)
            per_term[name] = L.mse(pred, y)
        if fuse_values:
            preds = model_apply(torch.cat([batches[n][0] for n in value_names], dim=0))
            ofs = 0
            for n in value_names:
                b = batches[n][0].shape[0]
                per_term[n] = L.mse(preds[ofs : ofs + b], batches[n][1])
                ofs += b
        total = sum(terms[n].weight * per_term[n] for n in names)
        return total, per_term

    def step_fn(params: Sequence[torch.Tensor], opt_state, sched, generator):
        batches = {n: terms[n].sampler.sample(generator, terms[n].batch)
                   for n in names}
        loss, per_term = loss_fn(batches)
        grads = torch.autograd.grad(loss, list(params), allow_unused=True)
        # a parameter the loss does not reach (the quantum block while it
        # is zeroed) gets a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        updates, opt_state = optimizer.update(grads, opt_state, params)
        if use_plateau:
            updates = optim.scale_updates(updates, sched.scale)
        optim.apply_updates(params, updates)
        loss = loss.detach()
        if use_plateau:
            sched = optim.plateau_update(
                sched, loss, factor=config.plateau_factor,
                patience=config.effective_plateau_patience,
            )
        metrics = {k: v.detach() for k, v in per_term.items()}
        metrics["loss"] = loss
        metrics["lr_scale"] = sched.scale
        return opt_state, sched, metrics

    def run_steps(params, opt_state, sched, generator, n_steps: int):
        trace = []
        for _ in range(n_steps):
            opt_state, sched, metrics = step_fn(params, opt_state, sched, generator)
            trace.append(metrics)
        stacked = {k: torch.stack([m[k] for m in trace]) for k in trace[0]} if trace else {}
        return opt_state, sched, stacked

    return step_fn, run_steps
