"""Physics-informed train step (port of qcpinn_tpu/train/loop.py:
``TermSpec`` and ``make_train_step`` in backprop mode).

One step: sample every term's points -> forward -> PDE residual (the
tangent-stream ``residual_fn`` or a generic ``operator``) -> weighted MSE
-> grad -> clip + Adam (``train/optim.py``) -> plateau scheduler.

The JAX package compiles the step and scans a chunk of steps in one
dispatch (``jax.jit`` of ``lax.scan``). On the card the port captures one
step in a CUDA graph (:class:`CapturedStep`) and replays it once a step:
the host then launches one graph where the eager step launched thousands
of kernels. The eager ``step_fn`` stays as the plain version: the CPU
runs it, and on the card a caller that compares against it calls it
directly. The host waits on the device only when the caller reads a
metric.

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

WARMUP_STEPS = 3  # eager steps before a capture (CapturedStep)


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
    ``run_steps(..., n_steps)`` (a :class:`StepRunner`) runs that many
    steps of ``step_fn`` bound to static tensors and returns the metric
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

    return step_fn, StepRunner(step_fn)


class StepRunner:
    """``run_steps(params, opt_state, sched, generator, n_steps) ->
    (opt_state, sched, trace)``: ``n_steps`` steps of ``step_fn`` bound to
    these ``params``, ``opt_state``, ``sched`` and ``generator``
    (:func:`static_step`, which updates them in place; they come back as
    given), the trace of each metric stacked over the steps on the device.
    On the card the bound step is a :class:`CapturedStep` (``captured``),
    replayed once a step after its warm-up; on the CPU it runs eagerly. A
    call with other tensors binds them anew (a new capture on the card)."""

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.binding: tuple = ()
        self.names: list = []
        self.captured: Optional[CapturedStep] = None
        self._step: Optional[Callable[[], torch.Tensor]] = None

    def __call__(self, params, opt_state, sched, generator, n_steps: int):
        binding = (*params, opt_state, sched, generator)
        if len(binding) != len(self.binding) or any(
                a is not b for a, b in zip(binding, self.binding)):
            step, self.names = static_step(self.step_fn, params, opt_state, sched,
                                           generator)
            on_card = params[0].device.type == "cuda"
            self.captured = CapturedStep(step, generator) if on_card else None
            self.binding, self._step = binding, self.captured or step
        trace = None
        for i in range(n_steps):
            out = self._step()
            if trace is None:
                trace = torch.empty((n_steps, out.numel()), dtype=out.dtype,
                                    device=out.device)
            trace[i].copy_(out)
        if trace is None:
            return opt_state, sched, {}
        return opt_state, sched, {k: trace[:, j] for j, k in enumerate(self.names)}


def static_step(step_fn, params, opt_state, sched, generator):
    """``step_fn`` bound to static tensors, as a CUDA graph needs it:
    (step, metric names). ``step()`` takes one step; the parameters and the
    optimizer state are updated in place (``optim.make_optimizer`` does
    so), the plateau state is copied into ``sched``'s tensors, and the
    metrics come back as one vector in the order of ``names`` (filled at
    the first call)."""
    names = []

    def step() -> torch.Tensor:
        new_opt, new_sched, metrics = step_fn(params, opt_state, sched, generator)
        if new_opt is not opt_state:
            raise ValueError("a static step needs an optimizer that updates "
                             "its state in place")
        if new_sched is not sched:
            with torch.no_grad():
                for dst, src in zip(sched, new_sched):
                    dst.copy_(src)
        if not names:
            names.extend(metrics)
        return torch.stack([metrics[k].to(torch.float32) for k in names])

    return step, names


class CapturedStep:
    """One train step captured in a CUDA graph and replayed once a step (the
    port's counterpart of the JAX package's jitted step scanned over a
    chunk, ``qcpinn_tpu/train/loop.py``).

    ``step()`` works on static tensors: it updates the parameters and the
    optimizer and scheduler state in place and returns its metrics as one
    tensor. The first ``warmup`` calls run it eagerly on a side stream, so
    that kernel builds, ``cudaFuncSetAttribute``, the occupancy queries and
    the cuBLAS workspaces all happen before the capture; the next call
    captures one step, with ``generator`` (the samplers') registered with
    the graph, and replays it; every later call replays it. Each call is
    one training step and returns the step's metrics (the graph's static
    output after a replay: read or copy it before the next call). A capture
    that fails raises.

    The kernels' launch counters (``LAUNCHES``) count in Python, so they see
    the warm-up steps and the captured step, never a replay:
    ``eager_steps`` and ``captured`` say how many steps they saw, and
    ``replays`` how many steps ran without them."""

    def __init__(self, step: Callable[[], torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 warmup: int = WARMUP_STEPS):
        self.step = step
        self.generator = generator
        self.warmup = warmup
        self.graph = None
        self.out = None
        self.eager_steps = 0
        self.captured = 0
        self.replays = 0
        self._side = torch.cuda.Stream()

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            if self.eager_steps < self.warmup:
                self._side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self._side):
                    out = self.step()
                torch.cuda.current_stream().wait_stream(self._side)
                self.eager_steps += 1
                return out
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with torch.cuda.graph(graph):
                self.out = self.step()
            self.graph = graph
            self.captured = 1
        self.graph.replay()
        self.replays += 1
        return self.out
