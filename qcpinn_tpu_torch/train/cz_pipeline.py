"""Two-phase Czochralski training pipeline (port of
qcpinn_tpu/train/cz_pipeline.py; CG_HQPINN_IBMtest_16qubits.py:471-613).

Phase "pretrain" (the reference's Aer stage): exact simulation, clipped
Adam with a per-epoch cosine learning rate, EMA-normalized physics
weighting with warmup and ramp, minibatches over the COMSOL node set. One
step (data and physics loss, EMA update, Adam) over host-looped batches; on
the card the step is one captured CUDA graph (``train/loop.py``
``CapturedStep``) replayed a batch, the batch copied into its static
buffers and the epoch's learning rate and physics weight written into
device scalars before the epoch.

Phase "finetune" (the reference's IBM stage): shot-sampled measurements
(the hardware-fidelity mode standing in for the cloud QPU), data MSE only
on a coverage-chosen calibration subset, head scope (only ``post`` trains,
through the detached sampled measurement: the reference's
freeze_for_ibm_head_tuning) or full scope (the circuit through the
parameter-shift estimator, ``train/hardware_grad.make_hw_apply_cz``: the
reference's diff_method="parameter-shift" QNode). Every draw of a step (its
shots, each shifted evaluation's shots) takes the step's generator, which a
captured step registers.

Deviations from the reference (the JAX package's): the batches are
drop_last, the dropped tail rotating across epochs by the reshuffle. The
port's draws (the shuffle, the shots) come from ``torch.Generator``s, not
``jax.random``, so runs compare with JAX's by band.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..bridge import params_from_jax, params_to_jax
from ..data.cz_loader import DataStats, choose_calibration_subset
from ..models.czochralski import Hybrid16QPINN
from ..parallel.collectives import psum
from ..parallel.mesh import replicate, shard_batch
from ..physics.cylindrical import cz_residuals
from ..physics.jet import cz_residuals_jet
from ..physics.operators_fwd import cz_residuals_fwd
from ..utils import spans
from . import optim
from .loop import CapturedStep, profile_trace

PHYS_KEYS = ("cont", "mom_r", "mom_z", "swirl", "energy")
EMA_KEYS = ("data",) + PHYS_KEYS + ("abs_data", "abs_phys")
# rows a chunk of the nested-jvp residual when remat is on (see
# PretrainEpoch)
REMAT_ROWS = 256
# PretrainEpoch.residual_path by residual function
RESIDUAL_PATHS = {cz_residuals_jet: "jet", cz_residuals_fwd: "jvp", cz_residuals: "rev"}


@dataclasses.dataclass
class CzConfig:
    # defaults track the reference flagship CLI
    # (CG_HQPINN_IBMtest_16qubits.py:627-648)
    n_qubits: int = 16
    n_layers: int = 2
    epochs: int = 2000
    batch_size: int = 16
    lr: float = 1e-3
    seed: int = 42
    re: float = 15.0
    pr: float = 28.463
    gr: float = 8000.0
    physics_weight: float = 0.05
    physics_warmup: int = 150
    physics_ramp: int = 400
    ema_beta: float = 0.95
    log_every: int = 10
    # finetune phase
    finetune_epochs: int = 100
    finetune_lr: float = 1e-4
    shots: Optional[int] = 4096
    calib_size: int = 8
    train_scope: str = "head"  # head | full
    # FakeSherbrooke-style noisy-simulator finetune (the reference's
    # --phase ibm-sim, cg-hqpinn/CG_HQPINN_IBMtest_16q_effective.py:183-196)
    noise_depolarizing: float = 0.0
    noise_readout: float = 0.0
    # depth-aware per-gate depolarizing (ops/measure.py)
    noise_per_gate: float = 0.0
    # 'fwd' = forward-mode residuals (the model's second-order jet, or
    # nested jvps on an amp-sharded circuit; the model is point-decoupled);
    # 'rev' = reverse mode
    physics_mode: str = "fwd"
    # Physics-vs-data balancing (the JAX CzConfig's comment has the record):
    #   'reference' - each term's EMA of its ratio to the all-term average
    #     (EMAWeights, CG_HQPINN_IBMtest_16qubits.py:408-422); with raw
    #     residuals ~1e12 the loss is effectively pure physics.
    #   'balanced' - physics scaled to the data loss by absolute-magnitude
    #     EMAs: w * phys_total * sg(ema_data / ema_phys).
    #   'coupled' - the trainable CoupledAdaptiveWeighting
    #     (modified_qpinn_cg.py:142-156), its leaf 'loss_bal' a training
    #     artifact, stripped from checkpoints.
    physics_normalize: str = "reference"
    coupled_ratio: float = 100.0
    # rematerialize the circuit in reverse mode: None = auto (on for
    # batch > 256)
    remat: Optional[bool] = None
    # per-field data-loss weights over (u_r, u_z, u_theta, p, T), mean 1
    field_weights: Optional[Tuple[float, ...]] = None

    @property
    def effective_remat(self) -> bool:
        return self.batch_size > 256 if self.remat is None else self.remat

    def norm_field_weights(self, device=None) -> Optional[torch.Tensor]:
        """field_weights as a mean-1 ``[5]`` f32 tensor on ``device``, or
        None."""
        if self.field_weights is None:
            return None
        w = torch.as_tensor(self.field_weights, dtype=torch.float32, device=device)
        if w.ndim != 1 or w.numel() != 5:
            raise ValueError("field_weights must be 5 values (u_r,u_z,u_theta,p,T)")
        if any(v < 0 for v in self.field_weights) or sum(self.field_weights) <= 0:
            # a zero sum divides to inf/NaN; a negative weight flips that
            # field's loss into a reward
            raise ValueError(
                "field_weights must be non-negative with a positive sum, "
                f"got {self.field_weights}")
        return w * (w.numel() / torch.sum(w))


def _cosine_lr(base_lr: float, epoch: float, t_max: int) -> float:
    """The epoch's learning rate, computed in f32 as JAX computes it."""
    c = np.cos(np.float32(math.pi * epoch / max(t_max, 1)))
    return float(np.float32(base_lr * 0.5) * (np.float32(1.0) + c))


def _phys_weight(cfg: CzConfig, epoch: float) -> float:
    ramp = min(max((epoch - cfg.physics_warmup) / max(cfg.physics_ramp, 1), 0.0), 1.0)
    return float(np.float32(cfg.physics_weight * ramp))


def _log_fn(logger):
    return logger.print if logger is not None else print


class PretrainEpoch:
    """The pretrain phase's step and epoch on ``model``'s parameters (the
    twin of JAX's ``make_pretrain_epoch``: its ``optimizer``, ``step_fn``,
    ``shuffle`` and ``epoch_fn``, with ``n_batches``). The state is held in
    place: the model's trainable tensors (with ``loss_bal`` in the coupled
    mode), ``opt_state`` (clip 1.0 and Adam, ``train/optim.py``) and
    ``ema`` (device scalars, all 1 at the start).

    ``step_fn(xb, yb, phys_w, lr)`` takes one eager step and returns
    [total, data, phys]; calling the object, ``(epoch, generator)``,
    shuffles all rows on the device, drops the remainder after the
    shuffle (so the dropped rows rotate), and takes ``n_batches`` steps:
    on the card through one captured CUDA graph, the plain version being
    ``step_fn``.

    The forward-mode residual (``physics_mode`` "fwd") is the model's
    second-order jet (``physics/jet.py::cz_residuals_jet``: one pass, five
    states through the circuit) where its circuit holds the whole state; on
    an amp-sharded circuit it is the nested jvps (``cz_residuals_fwd``).
    ``residual_path`` names the path: "jet", "jvp", "rev" or "none" (data
    only). With ``physics_weight == 0`` the residual is never built (the
    static data-only mode). With ``effective_remat`` the circuit's reverse
    pass runs in checkpointed segments, the jet's too.
    ``torch.utils.checkpoint`` does not compose with the nested
    ``torch.func.jvp``, so on the path "jvp" the residual and its gradient
    are taken in chunks of ``REMAT_ROWS`` rows instead, each chunk's graph
    freed once its gradient is summed, and the loss sees
    the sum through a linear stand-in whose value is the residual and whose
    gradient is the chunks' sum. The gradient is the same (each residual
    term is a mean over rows, the model point-decoupled); the peak memory
    is one chunk's.

    ``mesh`` (``parallel.make_mesh``) makes the step data-parallel, as
    ``train/loop.py``'s: every rank shuffles alike, keeps its rows of each
    batch, and sums its share of the data and physics terms over the 'data'
    axis, so the EMA balancer and the physics weight see the global values;
    the gradients are averaged over the world inside the step (in the
    captured graph on the card)."""

    def __init__(self, model: Hybrid16QPINN, X: np.ndarray, Y: np.ndarray,
                 stats: DataStats, cfg: CzConfig, mesh=None):
        self.model, self.stats, self.cfg, self.mesh = model, stats, cfg, mesh
        self.n_batches = len(X) // cfg.batch_size
        if self.n_batches == 0:
            raise ValueError("batch_size larger than dataset")
        b = cfg.batch_size
        if mesh is not None:
            if b % mesh.shape["data"]:
                raise ValueError(f"batch_size {b} must divide over the 'data' axis of "
                                 f"{mesh.shape['data']} devices")
            replicate(model, mesh)
            b //= mesh.shape["data"]
        # this rank's share of a batch's rows
        self.frac = b / cfg.batch_size
        dev = model.device
        self.device = dev
        # the full dataset on the device; each epoch permutes all of it
        self.Xd = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        self.Yd = torch.as_tensor(np.asarray(Y, np.float32), device=dev)
        self.params = [p for p in model.parameters() if p.requires_grad]
        # optax.chain(clip_by_global_norm(1.0), scale_by_adam(), scale(-1)),
        # the lr multiplied in per epoch
        self.optimizer = optim.make_optimizer(1.0, grad_clip=1.0, schedule="none")
        self.opt_state = self.optimizer.init(self.params)
        self.ema = {k: torch.ones((), device=dev) for k in EMA_KEYS}
        if cfg.physics_mode == "rev":
            self.residual_fn = cz_residuals
        elif model.qlayer.sharded is None:
            self.residual_fn = cz_residuals_jet
        else:
            self.residual_fn = cz_residuals_fwd
        self.fw = cfg.norm_field_weights(dev)
        self.data_only = cfg.physics_weight == 0.0
        self.xb = torch.zeros((b, self.Xd.shape[1]), device=dev)
        self.yb = torch.zeros((b, self.Yd.shape[1]), device=dev)
        self.phys_w = torch.zeros((), device=dev)
        self.lr = torch.zeros((), device=dev)
        self.captured = CapturedStep(self.static_step) if dev.type == "cuda" else None
        # the step a batch runs, None for static_step (no reference to a
        # bound method of self: the epoch goes with its last reference)
        self._step = self.captured

    @property
    def residual_path(self) -> str:
        """The residual's path: "jet", "jvp", "rev", or "none" where the
        step is data only."""
        return "none" if self.data_only else RESIDUAL_PATHS[self.residual_fn]

    @property
    def chunk_rows(self) -> Optional[int]:
        """Rows a chunk of the residual: ``REMAT_ROWS`` under remat on the
        nested jvps (path "jvp") where a batch holds more, else None."""
        b = self.xb.shape[0]
        return (REMAT_ROWS if self.cfg.effective_remat and self.residual_path == "jvp"
                and b > REMAT_ROWS else None)

    def residual(self, xb: torch.Tensor):
        s, cfg = self.stats, self.cfg
        return self.residual_fn(self.model, xb, s.pressure_coeff, cfg.re, cfg.pr, cfg.gr)

    def chunked_residual(self, xb: torch.Tensor):
        """(stand-in total, detached terms): the residual over ``xb`` in
        chunks of ``chunk_rows`` rows, each chunk's gradient taken at once."""
        b = xb.shape[0]
        terms = {k: torch.zeros((), device=xb.device) for k in PHYS_KEYS}
        grads = [torch.zeros_like(p) for p in self.params]
        for i in range(0, b, self.chunk_rows):
            xc = xb[i:i + self.chunk_rows]
            w = xc.shape[0] / b
            total_c, terms_c = self.residual(xc)
            g = torch.autograd.grad(total_c, self.params, allow_unused=True)
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(gi, alpha=w)
            for k in PHYS_KEYS:
                terms[k] = terms[k] + w * terms_c[k].detach()
        value = sum(terms.values())
        # value + 0 with gradient sum(grads): (p g) - (sg(p) g) is exactly 0
        link = sum(torch.sum(p * g) - torch.sum(p.detach() * g)
                   for p, g in zip(self.params, grads))
        return value + link, terms

    def batch_loss(self, xb, yb, phys_w):
        """(total, data loss, physics total, the new EMA state): the spans
        ``data_forward`` (the model and the data loss; again after the
        residual, the EMA update and the loss's combination) and
        ``residual``."""
        cfg, ema = self.cfg, self.ema
        with spans.span("data_forward", xb):
            pred = self.model(xb)
            sq = (pred - yb) ** 2
            data_loss = torch.mean(sq if self.fw is None else sq * self.fw)
        with spans.span("residual", xb):
            if self.data_only:
                phys_total = torch.zeros((), device=xb.device)
                phys_terms = {k: torch.zeros((), device=xb.device) for k in PHYS_KEYS}
            elif self.chunk_rows is not None:
                phys_total, phys_terms = self.chunked_residual(xb)
            else:
                phys_total, phys_terms = self.residual(xb)
        with spans.span("data_forward", xb):
            if self.mesh is not None:
                # every term is a mean over this rank's rows: its share of the
                # global mean, summed over 'data' in one all-reduce
                parts = psum(torch.stack([data_loss, phys_total, *phys_terms.values()])
                             * self.frac, self.mesh.axis("data"))
                data_loss, phys_total = parts[0], parts[1]
                phys_terms = dict(zip(phys_terms, parts[2:]))
            # EMA-normalized physics weight (:510-513): the weights are EMA'd
            # relative magnitudes; only the mean physics weight scales the loss
            detached = {"data": data_loss.detach(),
                        **{k: v.detach() for k, v in phys_terms.items()}}
            avg = torch.clamp(sum(detached.values()) / len(detached), min=1e-12)
            beta = cfg.ema_beta
            new_ema = {k: beta * ema[k] + (1.0 - beta) * (v / avg) for k, v in detached.items()}
            new_ema["abs_data"] = beta * ema["abs_data"] + (1.0 - beta) * detached["data"]
            new_ema["abs_phys"] = beta * ema["abs_phys"] + (1.0 - beta) * phys_total.detach()
            if cfg.physics_normalize == "coupled":
                from ..models.si_gated import coupled_weighting_apply

                # the ramp in [0, 1] gates the physics term as the other modes'
                # warmup does; the magnitudes come from the learned eps
                ramp = phys_w / max(cfg.physics_weight, 1e-12)
                total = coupled_weighting_apply(self.model.loss_bal, data_loss,
                                                phys_total * ramp, target_ratio=cfg.coupled_ratio)
            elif cfg.physics_normalize == "balanced":
                scale = new_ema["abs_data"] / torch.clamp(new_ema["abs_phys"], min=1e-30)
                total = data_loss + phys_w * phys_total * scale.detach()
            else:
                mean_phys_w = sum(new_ema[k] for k in PHYS_KEYS) / len(PHYS_KEYS)
                total = data_loss + phys_w * (phys_total / torch.clamp(mean_phys_w, min=1e-12))
            return total, data_loss, phys_total, new_ema

    def step_fn(self, xb, yb, phys_w, lr) -> torch.Tensor:
        """One step on the batch (xb, yb) at physics weight ``phys_w`` and
        learning rate ``lr`` (tensors or floats): the parameters, the
        optimizer state and the EMA update in place. Returns [total, data,
        phys], detached. The span ``step``, tiled by ``data_forward``,
        ``residual``, ``data_forward`` (:meth:`batch_loss`), ``backward``
        (the gradient call, with the mesh's mean) and ``optimizer`` (the
        clip, Adam, the update and the EMA copies)."""
        with spans.span("step", xb):
            total, data_loss, phys_total, new_ema = self.batch_loss(xb, yb, phys_w)
            with spans.span("backward", xb):
                grads = torch.autograd.grad(total, self.params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(self.params, grads)]
                if self.mesh is not None:
                    grads = self.mesh.mean_grads(grads)
            with spans.span("optimizer", xb):
                updates, _ = self.optimizer.update(grads, self.opt_state, self.params)
                with torch.no_grad():
                    torch._foreach_mul_(updates, lr)
                    optim.apply_updates(self.params, updates)
                    for k in EMA_KEYS:
                        self.ema[k].copy_(new_ema[k])
                return torch.stack([total, data_loss, phys_total]).detach()

    def static_step(self) -> torch.Tensor:
        return self.step_fn(self.xb, self.yb, self.phys_w, self.lr)

    def __call__(self, epoch: int, generator: torch.Generator) -> dict:
        """One epoch at 1-based index ``epoch``: the physics weight's ramp,
        the cosine learning rate, a shuffle from ``generator``, then every
        batch. Returns the epoch's mean loss, data and physics terms (device
        scalars) and its phys_w and lr (floats)."""
        cfg = self.cfg
        e = float(epoch)
        phys_w, lr = _phys_weight(cfg, e), _cosine_lr(cfg.lr, e, cfg.epochs)
        self.phys_w.fill_(phys_w)
        self.lr.fill_(lr)
        b, nb = cfg.batch_size, self.n_batches
        with spans.host_span("shuffle"):
            perm = torch.randperm(len(self.Xd), generator=generator,
                                  device=self.device)[: nb * b]
            Xs, Ys = self.Xd[perm].reshape(nb, b, -1), self.Yd[perm].reshape(nb, b, -1)
            trace = torch.empty((nb, 3), device=self.device)
        for i in range(nb):
            with spans.host_span("feed"):
                xb, yb = Xs[i], Ys[i]
                if self.mesh is not None:
                    xb, yb = shard_batch(xb, self.mesh), shard_batch(yb, self.mesh)
                self.xb.copy_(xb)
                self.yb.copy_(yb)
            trace[i].copy_((self._step or self.static_step)())
        m = trace.mean(0)
        return {"loss": m[0], "data": m[1], "phys": m[2], "phys_w": phys_w, "lr": lr}


def make_pretrain_epoch(model: Hybrid16QPINN, X, Y, stats: DataStats, cfg: CzConfig,
                        mesh=None) -> PretrainEpoch:
    """The pretrain step and epoch (:class:`PretrainEpoch`), data-parallel
    over ``mesh``'s 'data' axis when given."""
    return PretrainEpoch(model, X, Y, stats, cfg, mesh)


def _strip_balancer(params: dict) -> dict:
    """The coupled-weighting leaf is a training artifact, not a model
    weight: checkpoints stay loadable against the model's own template."""
    return {k: v for k, v in params.items() if k != "loss_bal"}


def run_pretrain(
    model: Hybrid16QPINN,
    X: np.ndarray,
    Y: np.ndarray,
    stats: DataStats,
    cfg: CzConfig,
    logger=None,
    params: Optional[dict] = None,
    start_epoch: int = 0,
    checkpoint_fn=None,
    save_every: int = 0,
    time_budget_s: float = 0.0,
    mesh=None,
) -> Tuple[Hybrid16QPINN, list]:
    """Pretrain ``model`` in place; returns (model, loss history).
    ``params`` (a JAX-layout tree) warm-starts it; without it the weights
    are drawn anew from ``cfg.seed``. ``checkpoint_fn(params_tree, epoch,
    history)`` is called every ``save_every`` epochs. ``time_budget_s`` > 0
    stops after the epoch that crosses it (the caller saves the final
    checkpoint as usual). With ``QCPINN_PROFILE_DIR`` set in the environment
    the epochs run under ``torch.profiler`` with spans on, and the trace and
    the spans' summary are written there (``loop.profile_trace``)."""
    log = _log_fn(logger)
    if params is None:
        model.init(cfg.seed)
    else:
        model.load_state_dict(params_from_jax(params))
    if cfg.physics_normalize == "balanced" and cfg.physics_warmup < 1:
        # the balanced scale sg(ema_data/ema_phys) starts at its cold init
        # 1.0 and needs ~1/(1-beta) steps to converge
        log("WARNING: physics_normalize='balanced' with physics_warmup=0 "
            "applies physics while the magnitude EMAs are still at their "
            "cold init — use physics_warmup >= 1 so they converge first")
    if cfg.physics_normalize == "coupled" and not hasattr(model, "loss_bal"):
        from ..models.si_gated import coupled_weighting_init

        model.loss_bal = coupled_weighting_init().to(model.device)
        log(f"coupled adaptive weighting on (trainable eps_data, "
            f"ratio {cfg.coupled_ratio}; modified_qpinn_cg.py:142-156)")
    epoch_fn = make_pretrain_epoch(model, X, Y, stats, cfg, mesh=mesh)
    log(f"residual path: {epoch_fn.residual_path}")
    if cfg.effective_remat:
        log("remat: circuit segments checkpointed in reverse mode" + (
            "" if epoch_fn.chunk_rows is None else
            f"; the nested-jvp residual runs in chunks of {REMAT_ROWS} rows"))
    gen = torch.Generator(device=model.device).manual_seed(cfg.seed)

    history = []
    t0 = time.time()
    try:
        with profile_trace(os.environ.get("QCPINN_PROFILE_DIR"), model.device, log):
            for epoch in range(start_epoch + 1, cfg.epochs + 1):
                metrics = epoch_fn(epoch, gen)
                loss, data, phys = (float(v) for v in torch.stack(
                    [metrics["loss"], metrics["data"], metrics["phys"]]).tolist())
                history.append(loss)
                if epoch == 1 or epoch % cfg.log_every == 0 or epoch == cfg.epochs:
                    log(f"[PRETRAIN] epoch {epoch:04d}/{cfg.epochs} | "
                        f"loss={loss:.4e} | data={data:.4e} | "
                        f"phys={phys:.4e} | phys_w={metrics['phys_w']:.3e} | "
                        f"lr={metrics['lr']:.2e} | elapsed={time.time()-t0:.1f}s")
                if checkpoint_fn is not None and save_every and epoch % save_every == 0:
                    checkpoint_fn(_strip_balancer(params_to_jax(model)), epoch, history)
                if time_budget_s > 0 and time.time() - t0 > time_budget_s:
                    log(f"[PRETRAIN] time budget {time_budget_s:.0f}s reached at "
                        f"epoch {epoch}/{cfg.epochs} — stopping gracefully")
                    break
    finally:
        if hasattr(model, "loss_bal"):
            del model.loss_bal
    return model, history


class FinetuneStep:
    """The finetune phase's step on the calibration subset: ``step()``
    takes one Adam step (lr ``finetune_lr``) of the field-weighted data MSE
    under shot-sampled readout, draws from ``generator``, and returns the
    loss; on the card ``run()`` replays one captured CUDA graph with the
    generator registered (each replay draws afresh), the plain version
    being ``step``. Head scope steps ``post`` only (the measurement
    detached: JAX masks the other gradients to zero, which leaves Adam's
    update of them exactly zero); full scope steps every parameter through
    the parameter-shift estimator."""

    def __init__(self, model: Hybrid16QPINN, X: np.ndarray, Y: np.ndarray, cfg: CzConfig,
                 generator: torch.Generator):
        from ..ops.measure import NoiseModel
        from .hardware_grad import make_hw_apply_cz

        self.model, self.cfg, self.generator = model, cfg, generator
        dev = model.device
        x_c, y_c = choose_calibration_subset(X, Y, cfg.calib_size)
        self.xb = torch.as_tensor(np.asarray(x_c, np.float32), device=dev)
        self.yb = torch.as_tensor(np.asarray(y_c, np.float32), device=dev)
        self.noise = None
        if cfg.noise_depolarizing or cfg.noise_readout or cfg.noise_per_gate:
            self.noise = NoiseModel(cfg.noise_depolarizing, cfg.noise_readout,
                                    cfg.noise_per_gate)
        self.q_apply = None
        if cfg.train_scope == "head":
            mask = Hybrid16QPINN.head_param_filter(model)
            self.params = [p for k, p in model.named_parameters() if mask[k]]
            self.detach_quantum = True
        elif cfg.train_scope == "full":
            # shot-sampled measurements re-evaluated at shifted parameters:
            # gradients reach the quantum weights and flow through the
            # inputs into the classical trunk
            self.params = [p for p in model.parameters() if p.requires_grad]
            self.detach_quantum = False
            self.q_apply = make_hw_apply_cz(model.qlayer, cfg.shots, noise=self.noise)
        else:
            raise ValueError(f"unsupported train_scope {cfg.train_scope!r}")
        self.optimizer = optim.make_optimizer(cfg.finetune_lr, schedule="none")
        self.opt_state = self.optimizer.init(self.params)
        self.fw = cfg.norm_field_weights(dev)
        self.captured = (CapturedStep(self.step, generator) if dev.type == "cuda"
                         else None)

    def loss(self) -> torch.Tensor:
        cfg = self.cfg
        pred = self.model(self.xb, shots=cfg.shots, key=self.generator, noise=self.noise,
                          detach_quantum=self.detach_quantum, q_apply=self.q_apply)
        sq = (pred - self.yb) ** 2
        return torch.mean(sq if self.fw is None else sq * self.fw)

    def step(self) -> torch.Tensor:
        loss = self.loss()
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        updates, _ = self.optimizer.update(grads, self.opt_state, self.params)
        optim.apply_updates(self.params, updates)
        return loss.detach()

    def run(self) -> torch.Tensor:
        return (self.captured or self.step)()


def run_finetune(
    model: Hybrid16QPINN,
    params: Optional[dict],
    X: np.ndarray,
    Y: np.ndarray,
    stats: DataStats,
    cfg: CzConfig,
    logger=None,
) -> Tuple[Hybrid16QPINN, list]:
    """Shot-noise fine-tuning on the calibration subset (:544-613), in
    place; ``params`` (a JAX-layout tree, or None for the model's own
    weights) is where it starts. Returns (model, loss history)."""
    del stats  # the normalization is already applied to X, Y
    log = _log_fn(logger)
    if params is not None:
        model.load_state_dict(params_from_jax(params))
    gen = torch.Generator(device=model.device).manual_seed(cfg.seed + 1)
    ft = FinetuneStep(model, X, Y, cfg, gen)
    # the circuit-execution budget (the reference prints it for hardware
    # runs, cg-hqpinn/...:711-718): head scope 1 evaluation a step, full
    # scope the shift rules' count
    if cfg.train_scope == "full":
        from .hardware_grad import evals_per_step_cz

        per_step = evals_per_step_cz(model.qlayer)
    else:
        per_step = 1
    log(f"[FINETUNE] circuit-execution budget: {cfg.finetune_epochs} epochs x "
        f"{per_step} evals/step x {cfg.calib_size} samples x "
        f"{cfg.shots or 'exact'} shots (scope={cfg.train_scope})")
    history = []
    for epoch in range(1, cfg.finetune_epochs + 1):
        history.append(float(ft.run()))
        if epoch == 1 or epoch % cfg.log_every == 0 or epoch == cfg.finetune_epochs:
            log(f"[FINETUNE] epoch {epoch:04d}/{cfg.finetune_epochs} | "
                f"data={history[-1]:.4e} | shots={cfg.shots} | scope={cfg.train_scope}")
    return model, history
