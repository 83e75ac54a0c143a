"""Physics-informed training (port of qcpinn_tpu/train/loop.py):
``TermSpec``, ``diffusion_terms``, ``make_train_step`` with the loss
balancers and the gradient modes (backprop, parameter-shift on
shot-sampled value terms, SPSA and the split SPSA/Adam update),
``inject_balancer_params``, ``make_val_fn`` and the training loop ``train``.

One step: sample every term's points -> forward -> PDE residual (the
tangent-stream ``residual_fn`` or a generic ``operator``) -> weighted MSE
(or a balancer's combination) -> grad -> clip + decay + Adam
(``train/optim.py``) -> plateau scheduler; in the SPSA modes the update is
``train/spsa.py``'s. Every random draw of a step (the points, the shots,
SPSA's perturbation) comes from the step's generator.

The JAX package compiles the step and scans a chunk of steps in one
dispatch (``jax.jit`` of ``lax.scan``). On the card the port captures one
step in a CUDA graph (:class:`CapturedStep`) and replays it once a step:
the host then launches one graph where the eager step launched thousands
of kernels. The eager ``step_fn`` stays as the plain version: the CPU
runs it, and on the card a caller that compares against it calls it
directly. The host waits on the device only when the caller reads a
metric (``train`` reads each chunk's trace once).

On a device mesh (``parallel/mesh.py``, one process a device) every rank
draws the same global batch from the same generator and keeps its rows of
it (the 'data' axis); each loss term is its rows' sum over the term's
global count, summed over 'data', so the balancers, the scheduler and the
logged history see the global values; the gradients are averaged over the
world before the clip and Adam, so every rank takes the single-device step.
The gradient all-reduce runs inside the step, so a captured step holds it
(its first run is one of the eager warm-ups).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..bridge import params_from_jax
from ..parallel.collectives import psum
from ..parallel.mesh import replicate, shard_batch
from ..utils import spans
from . import losses as L
from . import optim
from .spsa import SPSAConfig, spsa_split_step, spsa_step, split_params

WARMUP_STEPS = 3  # eager steps before a capture (CapturedStep)
GRADIENT_MODES = ("backprop", "parameter-shift", "spsa", "spsa-split")
# the sample stream's seed is the config's plus this, so that it is not the
# stream the model's initial weights were drawn from
SAMPLE_SEED_OFFSET = 1_000_003


@dataclasses.dataclass(frozen=True)
class TermSpec:
    """One loss term: where its points come from, how many, its weight, and
    whether the model output ('value') or the PDE residual ('residual') is
    matched to the sampler's target."""

    sampler: object  # has sample(generator, n) -> (X, y)
    weight: float
    batch: int
    kind: str = "value"  # value | residual


def diffusion_terms(
    samplers: Dict[str, object],
    batch_size: int,
    weights: Tuple[float, float, float] = (2.0, 4.0, 2.0),
) -> Dict[str, TermSpec]:
    """The canonical diffusion loss (trainer/diffusion_train.py:30-47):
    residual over the full batch, IC and BC1 at batch/3 each, weights
    (w_res, w_bc, w_ic). The reference samples only bcs_sampler[0]."""
    w_r, w_bc, w_ic = weights
    third = max(batch_size // 3, 1)
    return {
        "res": TermSpec(samplers["res"], w_r, batch_size, "residual"),
        "bc": TermSpec(samplers["bc1"], w_bc, third, "value"),
        "ic": TermSpec(samplers["ics"], w_ic, third, "value"),
    }


class BufferDict(nn.Module):
    """Named scalar buffers: the EMA balancer's state, which the step
    overwrites by its own rule (never by the optimizer) and which is saved
    with the model's parameters."""

    def __init__(self, values: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in values.items():
            self.register_buffer(k, v)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())


def inject_balancer_params(model: nn.Module, terms, balancer: str) -> nn.Module:
    """Attach the balancer's tensors to ``model`` (nothing for 'none' or when
    present already, as on resume), so they are saved and restored with its
    parameters: ``model.loss_log_vars``, trainable log-variances, for
    'uncertainty'; ``model.loss_ema``, the EMA state (buffers), for 'ema'.
    The JAX package keeps the same leaves in its params tree."""
    device = next(model.parameters()).device
    if balancer == "uncertainty" and not hasattr(model, "loss_log_vars"):
        model.loss_log_vars = nn.ParameterDict({
            k: nn.Parameter(v) for k, v in L.uncertainty_init(terms, device).items()})
    if balancer == "ema" and not hasattr(model, "loss_ema"):
        model.loss_ema = BufferDict(L.ema_weights_init(terms, device))
    return model


def make_train_step(
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    operator: Callable,
    terms: Dict[str, TermSpec],
    optimizer: optim.GradientTransformation,
    config,
    mesh=None,
    residual_fn: Optional[Callable] = None,
    shots_apply: Optional[Callable] = None,
    quantum_keys: Tuple[str, ...] = ("q",),
    fuse_value_terms: bool = False,
    balancer: str = "none",
    data_axis: str = "data",
):
    """Build (step_fn, run_steps).

    ``model_apply(X) -> [B, out]`` runs the model with its current
    parameters; ``operator(apply, X) -> (u, residual)``. When
    ``residual_fn(X) -> (u, residual)`` is given it replaces the operator
    for 'residual' terms (the tangent-stream residuals). With
    ``fuse_value_terms`` every value term goes through ONE ``model_apply``
    on the concatenated points (never with ``shots_apply``).

    ``shots_apply(X, key) -> [B, out]`` replaces ``model_apply`` for 'value'
    terms: the hardware-fidelity forward (shot-sampled, e.g. a solver's
    ``hw_apply_fn`` with its parameter-shift backward), one fresh draw from
    the step's generator a term. Residual terms always run the exact
    simulator: a state-derivative residual is not a hardware observable,
    and the reference's hardware stages train data and boundary losses only
    (readme.md:166-171).

    ``config.gradient_mode == "spsa"`` replaces the gradient step by a
    2-evaluation SPSA estimate of the whole weighted loss (train/spsa.py),
    applied to every trainable tensor; ``"spsa-split"`` perturbs only the
    quantum tensors (first name component in ``quantum_keys``) while the
    classical ones take ``optimizer`` steps from a backprop gradient with
    the quantum block held fixed (cg-hqpinn/...16q_effective.py:484-512,
    :727-748); ``optimizer``'s state then covers the classical tensors
    only, and ``model_apply`` is the model module. In both the plateau
    scale modulates the gains (``lr_scale``); in 'spsa' the clip and decay
    of the optimizer do not apply, in 'spsa-split' they apply to the
    classical partition. The step counter k of the decaying gains is the
    optimizer state's device count plus one (in 'spsa' the step counts it
    there itself).

    ``balancer`` selects the adaptive loss balancing (train/losses.py),
    whose tensors ``inject_balancer_params`` attaches to the model (here
    ``model_apply``):

    - ``"none"``: the static TermSpec weights.
    - ``"uncertainty"``: total = sum_k exp(-s_k) L_k + s_k with one
      trainable log-variance per term (``model.loss_log_vars``, among the
      parameters the optimizer steps), replacing the static weights.
    - ``"ema"``: each term's static weight divided by the EMA of its
      ratio-to-average magnitude (``model.loss_ema``, buffers: the step
      computes the new EMA from the detached term losses, weighs with it
      and copies it into the buffers in place after the update, inside the
      captured graph on the card).

    ``mesh`` (``parallel.make_mesh``) runs the step data-parallel over its
    ``data_axis``: each rank computes its rows of every exact term (a
    ``batch_coupled`` model, the Hopfield baseline, inside its
    ``batch_sharded`` context, so its attention spans the global batch),
    the terms are summed over the axis and the gradients averaged over the
    world (see the module docstring). A shot-sampled term runs on every rank
    over all its rows: its draws come from the shared generator, so the
    ranks stay in step and draw what the single-device run draws.

    ``step_fn(params, opt_state, sched, generator) -> (opt_state, sched,
    metrics)`` updates ``params`` (the model's trainable tensors) in place;
    ``run_steps(..., n_steps)`` (a :class:`StepRunner`) runs that many
    steps of ``step_fn`` bound to static tensors and returns the metric
    trace stacked over steps. Nothing synchronises with the host."""
    if balancer not in ("none", "ema", "uncertainty"):
        raise ValueError(
            f"unknown balancer {balancer!r}; have none, ema, uncertainty"
        )
    if config.gradient_mode not in GRADIENT_MODES:
        raise ValueError(f"unknown gradient_mode {config.gradient_mode!r}; "
                         f"have {GRADIENT_MODES}")
    use_spsa = config.gradient_mode == "spsa"
    use_split = config.gradient_mode == "spsa-split"
    if balancer != "none" and (use_spsa or use_split):
        raise ValueError(
            "adaptive balancers need gradient_mode='backprop' (SPSA "
            "perturbs the balancer state leaves)"
        )
    data = mesh.axis(data_axis) if mesh is not None else None
    coupled = data is not None and getattr(model_apply, "batch_coupled", False)
    state_name = {"uncertainty": "loss_log_vars", "ema": "loss_ema"}.get(balancer)
    if state_name is not None and not hasattr(model_apply, state_name):
        raise ValueError(f"balancer {balancer!r} needs model.{state_name}: "
                         "call inject_balancer_params first")
    log_vars = model_apply.loss_log_vars if balancer == "uncertainty" else None
    ema = model_apply.loss_ema.as_dict() if balancer == "ema" else None
    names = tuple(terms.keys())
    use_plateau = config.scheduler == "plateau"
    value_names = tuple(n for n in names if terms[n].kind != "residual")
    fuse_values = (fuse_value_terms and shots_apply is None and len(value_names) > 1
                   and not coupled)
    spsa_cfg = SPSAConfig(a=config.lr)
    if use_split:
        names_of = {id(p): n for n, p in model_apply.named_parameters()}

    def rows(t):
        return t if data is None else shard_batch(t, mesh, data_axis)

    def term_mse(pred, y, n):
        """The term's MSE over its ``n`` global rows from this rank's."""
        if data is None:
            return L.mse(pred, y)
        local = L.mse(pred, y) if pred.shape[0] else (pred - y).sum()
        return psum(local * (pred.shape[0] / n), data)

    def on_rows(n):
        if coupled:
            return model_apply.batch_sharded(mesh, n, data_axis)
        return contextlib.nullcontext()

    def loss_fn(batches, generator):
        per_term = {}
        for name in names:
            if fuse_values and name in value_names:
                continue
            X, y = batches[name]
            if terms[name].kind != "residual" and shots_apply is not None:
                per_term[name] = L.mse(shots_apply(X, generator), y)
                continue
            n = X.shape[0]
            X, y = rows(X), rows(y)
            with on_rows(n):
                if terms[name].kind == "residual":
                    if residual_fn is not None:
                        _, pred = residual_fn(X)
                    else:
                        _, pred = operator(model_apply, X)
                else:
                    pred = model_apply(X)
            per_term[name] = term_mse(pred, y, n)
        if fuse_values:
            parts = [(rows(batches[n][0]), rows(batches[n][1]), batches[n][0].shape[0])
                     for n in value_names]
            preds = model_apply(torch.cat([X for X, _, _ in parts], dim=0))
            ofs = 0
            for name, (X, y, n) in zip(value_names, parts):
                b = X.shape[0]
                per_term[name] = term_mse(preds[ofs : ofs + b], y, n)
                ofs += b
        if balancer == "uncertainty":
            # the log-variances replace the static weights, on the raw
            # term losses (si_q_pinn_improved.py:143-164)
            return L.uncertainty_combine(log_vars, per_term), per_term, None
        if balancer == "ema":
            detached = {k: v.detach() for k, v in per_term.items()}
            new_ema = L.ema_weights_update(ema, detached)
            total = sum(terms[n].weight * per_term[n]
                        / torch.clamp(new_ema[n].detach(), min=1e-8)
                        for n in names)
            return total, per_term, new_ema
        total = sum(terms[n].weight * per_term[n] for n in names)
        return total, per_term, None

    def step_fn(params: Sequence[torch.Tensor], opt_state, sched, generator):
        batches = {n: terms[n].sampler.sample(generator, terms[n].batch)
                   for n in names}
        lr_scale = sched.scale if use_plateau else 1.0
        if use_spsa or use_split:
            # per-term metrics ride the SPSA evaluations (has_aux): no extra
            # loss evaluation beyond the mode's own
            def terms_loss(g):
                total, per, _ = loss_fn(batches, g)
                return total, per

            k = opt_state.count.to(torch.float32) + 1.0
            if use_spsa:
                _, loss, per_term = spsa_step(terms_loss, params, k, generator, spsa_cfg,
                                              has_aux=True, lr_scale=lr_scale)
                with torch.no_grad():
                    opt_state.count.add_(1)
            else:
                named = {names_of[id(p)]: p for p in params}
                _, opt_state, loss, per_term = spsa_split_step(
                    terms_loss, named, k, generator, spsa_cfg, optimizer, opt_state,
                    quantum_keys=quantum_keys, has_aux=True, lr_scale=lr_scale,
                    reduce_grads=None if mesh is None else mesh.mean_grads)
        else:
            loss, per_term, new_ema = loss_fn(batches, generator)
            grads = torch.autograd.grad(loss, list(params), allow_unused=True)
            # a parameter the loss does not reach (the quantum block while
            # it is zeroed) gets a zero gradient, as in JAX
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if mesh is not None:
                grads = mesh.mean_grads(grads)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            if use_plateau:
                updates = optim.scale_updates(updates, sched.scale)
            optim.apply_updates(params, updates)
            if new_ema is not None:
                # the EMA state follows its own rule, never the optimizer
                with torch.no_grad():
                    for k, buf in ema.items():
                        buf.copy_(new_ema[k])
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
    the warm-up steps and the captured steps, never a replay:
    ``eager_steps`` and ``captured`` (the captures) say how many steps they
    saw, and ``replays`` how many steps ran without them. ``capture_s`` is
    the host's seconds from the first warm-up to the end of the first
    capture (the warm-ups' device work included: a capture begins by
    synchronising).

    Spans (``utils/spans.py``) are captured with the step: a graph holds
    their marks only if spans were on at its capture. When that no longer
    holds, the next call frees the graph and captures again (no new
    warm-up: the kernels are built), so spans can be turned on in a running
    process. With spans on, the warm-ups, the captures and the replays are
    host spans (``qc::warmup``, ``qc::capture``, ``qc::replay``).

    A bound method ``step`` is held weakly: its object owns this
    CapturedStep (``PretrainEpoch``, ``FinetuneStep``, ``CrystalTrainer``),
    and a strong reference back would make a cycle that keeps the graph and
    its memory pool alive until Python's cycle collector runs. So the graph
    goes when its owner does."""

    def __init__(self, step: Callable[[], torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 warmup: int = WARMUP_STEPS):
        if inspect.ismethod(step):
            self._ref = weakref.WeakMethod(step)
        else:
            self._ref = lambda: step
        self.generator = generator
        self.warmup = warmup
        self.graph = None
        self.out = None
        self.eager_steps = 0
        self.captured = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self._side = None
        self._t0: Optional[float] = None
        self._spans = False  # spans were on at the graph's capture
        self._layout: Optional[spans.Recording] = None  # the spans it recorded

    @property
    def step(self) -> Callable[[], torch.Tensor]:
        step = self._ref()
        if step is None:
            raise ReferenceError("the object whose method this CapturedStep runs is gone")
        return step

    def __call__(self) -> torch.Tensor:
        if self.graph is not None and self._spans != spans.enabled():
            self.graph = self.out = self._layout = None
        if self.graph is None:
            if self._t0 is None:
                self._t0 = time.perf_counter()
            if self.eager_steps < self.warmup:
                if self._side is None:
                    self._side = torch.cuda.Stream()
                with spans.host_span("warmup"):
                    self._side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(self._side):
                        out = self.step()
                    torch.cuda.current_stream().wait_stream(self._side)
                self.eager_steps += 1
                return out
            with spans.host_span("capture"):
                graph = torch.cuda.CUDAGraph()
                if self.generator is not None:
                    graph.register_generator_state(self.generator)
                recorded = spans.generation()
                with torch.cuda.graph(graph):
                    self.out = self.step()
            self.graph = graph
            self._spans = spans.enabled()
            if spans.generation() != recorded:
                self._layout = spans.last()
            self.captured += 1
            if self.capture_s is None:
                self.capture_s = time.perf_counter() - self._t0
        if self._layout is not None:
            spans.use(self._layout)
        with spans.host_span("replay"):
            self.graph.replay()
        self.replays += 1
        return self.out


@dataclasses.dataclass
class Stage:
    """One training run over a model's trainable tensors: the optimizer and
    plateau state, the sample stream, and ``make_train_step``'s two steps.
    ``run(n)`` takes n steps through ``run_steps`` (on the card, one
    captured CUDA graph replayed a step) and returns the metric trace;
    ``step()`` takes one eager step (the plain version) and returns its
    metrics."""

    label: str
    horizon: int
    params: list
    opt_state: object
    sched: object
    gen: torch.Generator
    step_fn: Callable
    run_steps: Callable

    def run(self, n: int) -> dict:
        self.opt_state, self.sched, trace = self.run_steps(
            self.params, self.opt_state, self.sched, self.gen, n)
        return trace

    def step(self) -> dict:
        self.opt_state, self.sched, metrics = self.step_fn(
            self.params, self.opt_state, self.sched, self.gen)
        return metrics


def make_val_fn(model_apply: Callable, X_val: torch.Tensor, y_val: torch.Tensor) -> Callable:
    """``val_fn() -> scalar tensor``: the validation MSE of the model as it
    stands, on a fixed set, for best-val tracking."""

    @torch.no_grad()
    def val_fn():
        return torch.mean((model_apply(X_val) - y_val) ** 2)

    return val_fn


def train_stage(
    model: nn.Module,
    config,
    terms: Dict[str, TermSpec],
    operator: Callable,
    device=None,
    resume: Optional[dict] = None,
    log: Callable[[str], None] = print,
    mesh=None,
) -> Tuple[Stage, int]:
    """``train``'s set-up, without its loop: (the stage, the step it starts
    at). The balancer's tensors are injected into ``model``; the optimizer
    is clip + coupled decay + Adam at the config's lr, schedule and
    horizon; the sample stream is a generator on ``device`` seeded from the
    config. ``resume`` ({"params": a JAX-layout tree, "opt_state",
    "sched", "rng", "step"}, as ``utils.checkpoint.load_checkpoint``'s
    bundle gives them, any of them absent or None) restores that state.
    Value terms are fused into one model call unless the model couples the
    batch (``batch_coupled``) or a shot-sampled forward serves them. The
    gradient mode picks that forward (``parameter-shift``: the model's
    ``hw_apply_fn(config.shots)``; the SPSA modes with ``shots``: the DV
    solver's sampled readout) and, for ``spsa-split``, an optimizer over the
    classical tensors alone (the model's ``quantum_param_keys``, default
    ``q``, name the quantum ones). ``mesh`` makes the step data-parallel
    (:func:`make_train_step`); rank 0's parameters are every rank's
    (``parallel.replicate``)."""
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"the model is on {on}; train on {device}")
    if mesh is not None and mesh.device != on:
        raise ValueError(f"the model is on {on}, the mesh's rank on {mesh.device}")
    balancer = config.loss_balancer
    inject_balancer_params(model, terms, balancer)
    if balancer != "none":
        log(f"adaptive loss balancer: {balancer} (train/losses.py; "
            "uncertainty replaces the static term weights, ema divides "
            "them by each term's EMA ratio-to-average)")
    optimizer = optim.make_optimizer(
        config.lr,
        grad_clip=config.effective_grad_clip,
        schedule=config.scheduler,
        epochs=config.epochs,
        weight_decay=config.effective_weight_decay,
    )
    gen = torch.Generator(device=on).manual_seed(config.seed + SAMPLE_SEED_OFFSET)
    resume = resume or {}
    if resume.get("params") is not None:
        model.load_state_dict(params_from_jax(resume["params"]))
    if resume.get("rng") is not None:
        gen.set_state(resume["rng"])
    if mesh is not None:
        replicate(model, mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    quantum_keys = tuple(getattr(model, "quantum_param_keys", ("q",)))
    stepped = params
    if config.gradient_mode == "spsa-split":
        # the optimizer covers only the classical partition: SPSA owns the
        # quantum tensors (cg-hqpinn/...16q_effective.py:700-748)
        q_part, c_part = split_params(
            {n: p for n, p in model.named_parameters() if p.requires_grad}, quantum_keys)
        if not q_part:
            raise ValueError(
                "gradient_mode='spsa-split' needs quantum parameters "
                f"(top-level key(s) {quantum_keys}); the "
                f"{config.solver} solver has none — use 'backprop' or 'spsa'"
            )
        stepped = list(c_part.values())
    opt_state = optimizer.init(stepped)
    if resume.get("opt_state") is not None:
        saved = resume["opt_state"]
        if [tuple(m.shape) for m in saved.mu] != [tuple(p.shape) for p in stepped]:
            raise ValueError("the saved optimizer state does not fit the model's "
                             "trainable tensors")
        opt_state = optim.AdamState(saved.count.to(on), [m.to(on) for m in saved.mu],
                                    [v.to(on) for v in saved.nu])
    sched = optim.plateau_init(on)
    if resume.get("sched") is not None:
        sched = optim.PlateauState(*(t.to(on) for t in resume["sched"]))
    # hardware-fidelity gradient modes (readme.md:166-171): simulator =
    # backprop on analytic expectations; hardware = parameter-shift on
    # shot-sampled measurements; SPSA = 2-eval zeroth order
    shots_apply = None
    if config.gradient_mode == "parameter-shift":
        if not hasattr(model, "hw_apply_fn"):
            raise ValueError(
                "gradient_mode='parameter-shift' needs a solver with a "
                "hardware apply (DVSolver.hw_apply_fn); CV/Classical "
                "solvers train with backprop or spsa"
            )
        shots_apply = model.hw_apply_fn(config.shots)
        log(f"parameter-shift gradients on value terms (shots={config.shots}); "
            "residual terms use the exact simulator (hardware stages are "
            "data/boundary-only, as in the reference)")
    elif config.gradient_mode in ("spsa", "spsa-split"):
        if config.shots is not None:
            if config.solver == "DV":
                def shots_apply(X, key):
                    return model(X, shots=config.shots, key=key)
            else:
                log("shots apply only to the DV solver's measurements; "
                    "SPSA runs on the analytic forward")
        if config.gradient_mode == "spsa-split":
            log(f"split updates: SPSA (a={config.lr}) on quantum leaves "
                f"{quantum_keys}, Adam on the classical partition "
                f"(the reference's hardware recipe); shots={config.shots}")
        else:
            log(f"SPSA updates on the FULL pytree (a={config.lr}); "
                f"shots={config.shots}")
    elif config.shots is not None:
        log(f"shots={config.shots} ignored: backprop mode trains on analytic "
            "expectations (the reference's AER semantics — 'Ignored in AER "
            "analytic mode'); use gradient_mode='parameter-shift' or 'spsa' "
            "for shot-noise training")
    step_fn, run_steps = make_train_step(
        model, operator, terms, optimizer, config, mesh=mesh, shots_apply=shots_apply,
        quantum_keys=quantum_keys,
        fuse_value_terms=not getattr(model, "batch_coupled", False),
        balancer=balancer,
    )
    stage = Stage("train", config.epochs, params, opt_state, sched, gen, step_fn,
                  run_steps)
    return stage, int(resume.get("step", 0))


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str], device: torch.device, log=print):
    """The ``QCPINN_PROFILE_DIR`` hook of ``train`` and ``cz_pipeline``'s
    ``run_pretrain`` (the JAX package's ``jax.profiler.start_trace``): with a
    directory, the body runs under ``torch.profiler`` (host and, on the
    card, device activity) with spans on (``utils/spans.py``), and a Chrome
    trace, ``train-<pid>-<time>.pt.trace.json``, is written into it; where
    the body recorded spans, so is their summary,
    ``spans-<pid>-<time>.json``: the last recorded step's spans by name
    (device ms, self ms, rows, count) and its edges in order (the k-th
    ``qc_span_mark`` of a step in the trace is the k-th edge). Without a
    directory, the body runs as it is."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with spans.turned_on(), profile(activities=activities) as prof:
        recorded = spans.generation()
        yield
    stem = f"{os.getpid()}-{int(time.time())}"
    prof.export_chrome_trace(os.path.join(profile_dir, f"train-{stem}.pt.trace.json"))
    if spans.generation() != recorded:
        with open(os.path.join(profile_dir, f"spans-{stem}.json"), "w") as f:
            json.dump({"spans": spans.read(), "edges": spans.layout()}, f, indent=1)
    log(f"profiler trace written to {profile_dir}")


def train(
    model: nn.Module,
    config,
    terms: Dict[str, TermSpec],
    operator: Callable,
    logger=None,
    mesh=None,
    checkpoint_fn: Optional[Callable] = None,
    resume: Optional[dict] = None,
    val_fn: Optional[Callable] = None,
    device=None,
) -> Tuple[nn.Module, list]:
    """Full training driver on ``device`` (default: the card; raises without
    CUDA). Trains ``model`` in place and returns it with the loss history.

    Chunks of ``print_every`` steps run through the stage's ``run_steps``
    (on the card, one captured CUDA graph replayed a step); the host reads
    each chunk's trace once and logs a line in the JAX package's format.
    ``resume`` continues a run (see :func:`train_stage`), the reference's
    --start-epoch/--load capability (cg-hqpinn/...:802-804).
    ``checkpoint_fn(model, stage, step, loss_history)`` is called after
    every chunk. ``val_fn() -> scalar`` (:func:`make_val_fn`) enables
    best-validation tracking (si_q_pinn_improved.py:608-624): it is
    evaluated after every chunk, and the parameters (and balancer state)
    with the lowest value are restored at the end. With ``QCPINN_PROFILE_DIR``
    set in the environment the training loop runs under ``torch.profiler``
    and its trace is written there (:func:`profile_trace`). ``mesh``
    (``parallel.make_mesh``) trains data-parallel (:func:`make_train_step`):
    every rank runs this loop and returns the same model and history."""

    def log(msg):
        if logger is not None:
            logger.print(msg)

    stage, start_step = train_stage(model, config, terms, operator, device, resume, log,
                                    mesh)

    loss_history: list = []
    best_val = float("inf")
    best_state = None
    chunk = max(1, min(config.print_every, config.epochs))
    done = start_step
    t0 = time.time()
    n_chunks = (max(config.epochs - start_step, 0) + chunk - 1) // chunk
    with profile_trace(os.environ.get("QCPINN_PROFILE_DIR"), stage.gen.device, log):
        for _ in range(n_chunks):
            n = min(chunk, config.epochs - done)
            trace = {k: v.tolist() for k, v in stage.run(n).items()}
            done += n
            loss_history.extend(trace["loss"])
            elapsed = time.time() - t0
            eta = elapsed / done * (config.epochs - done)
            term_str = " | ".join(f"{name}: {trace[name][-1]:.2e}" for name in terms)
            val_str = ""
            if val_fn is not None:
                v = float(val_fn())
                if v < best_val:
                    best_val = v
                    best_state = {k: t.detach().clone()
                                  for k, t in model.state_dict().items()}
                    val_str = f" | val: {v:.2e} (best)"
                else:
                    val_str = f" | val: {v:.2e} (best {best_val:.2e})"
            log(
                f"Epoch: {done}/{config.epochs} | Loss: {loss_history[-1]:.2e} | "
                f"{term_str} | lr_scale: {trace['lr_scale'][-1]:.2e}"
                f"{val_str} | Total: {elapsed:.1f}s | ETA: {eta:.1f}s"
            )
            if checkpoint_fn is not None:
                checkpoint_fn(model, stage, done, loss_history)
    if best_state is not None:
        log(f"restoring best-validation params (val={best_val:.2e})")
        model.load_state_dict(best_state)
    return model, loss_history
