"""Phase-field crystal-growth training (port of qcpinn_tpu/train/crystal.py;
the reference's SPSA session loop, hybrid_qpinn_2dcrystal_ibmtest.py:300-335)
around :class:`models.crystal.CrystalPINN`:

- every loss evaluation draws a FRESH adaptive interface sample set (the
  reference's ``loss_fn = lambda: crystal_growth_loss(model,
  adaptive_sampling(model))`` closure re-samples per call, :327-330), from
  the run's generator;
- SPSA gains are the reference's CONSTANT lr/delta (:271-294 has no decay),
  i.e. SPSAConfig(alpha=0, gamma=0);
- mode 'spsa' perturbs ONLY the quantum weights (the reference hands
  ``[model.q.weights]`` to its optimizer, :316-320; classical stays frozen);
  mode 'spsa-split' adds simultaneous Adam steps on the classical partition
  (the cg-hqpinn recipe, ...16q_effective.py:727-748);
- an optional classical warmup stage pre-trains the classical partition
  with Adam while the quantum weights are frozen: the staged recipe of
  test_hqpinn_cg.py:180-199 (``train_classical_only``).

The JAX package scans a chunk of steps in one jitted ``lax.scan``. Here a
step (adaptive sampling -> second-order crystal loss -> update) updates the
model's tensors in place; on the card each stage's step is captured in a
CUDA graph (``train/loop.py::CapturedStep``, the generator registered) and
replayed once a step, the eager step being the plain version. The host
reads the losses once a logging chunk.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..bridge import params_from_jax
from ..physics.phase_field import adaptive_interface_sampling, crystal_growth_loss
from . import optim
from .loop import SAMPLE_SEED_OFFSET, CapturedStep
from .spsa import SPSAConfig, spsa_split_step, spsa_step, split_params


@dataclasses.dataclass
class CrystalConfig:
    n_qubits: int = 4
    n_layers: int = 3
    # reference constants (hybrid_qpinn_2dcrystal_ibmtest.py:57-63)
    spsa_steps: int = 50
    spsa_lr: float = 0.02
    spsa_delta: float = 0.01
    n_bulk: int = 32
    n_interface: int = 64
    # staged classical pretrain (test_hqpinn_cg.py:180-199); 0 = skip
    warmup_epochs: int = 0
    warmup_lr: float = 1e-3
    mode: str = "spsa"  # spsa (quantum-only) | spsa-split (quantum SPSA + classical Adam)
    seed: int = 0
    log_every: int = 5

    def __post_init__(self):
        if self.mode not in ("spsa", "spsa-split"):
            raise ValueError(f"unknown crystal mode {self.mode!r}")


def make_crystal_loss(model: nn.Module, cfg: CrystalConfig):
    """``loss_fn(key) -> scalar`` at the model's current parameters:
    adaptive sampling from ``key`` (a ``torch.Generator``) + crystal loss.

    The forward is the exact simulator: the crystal loss is built from input
    derivatives of the model (phi_x, lap phi), which a shot-sampled readout
    cannot provide (the reference's hardware script has the same structural
    constraint); SPSA remains the hardware-fidelity *update* rule on top of
    it."""

    def loss_fn(key: torch.Generator) -> torch.Tensor:
        x = adaptive_interface_sampling(model, key, n_bulk=cfg.n_bulk,
                                        n_interface=cfg.n_interface, device=model.device)
        return crystal_growth_loss(model, x)

    return loss_fn


class CrystalTrainer:
    """The two stages' steps on ``model``'s tensors, each draw from
    ``generator``. ``warmup_step()`` takes one Adam step (lr ``warmup_lr``)
    of the classical partition with the quantum weights frozen;
    ``spsa_step()`` one SPSA update of the quantum weights at constant gains
    (with ``spsa-split``, and an Adam step of the classical partition from
    its backprop gradient at the unperturbed point). Each returns the step's
    loss (SPSA: the mean of its two evaluations; split: the unperturbed
    one). ``run(stage, n)`` takes n steps of a stage, on the card through a
    captured CUDA graph, and returns their losses ``[n]``."""

    def __init__(self, model: nn.Module, cfg: CrystalConfig, generator: torch.Generator):
        self.model, self.cfg, self.gen = model, cfg, generator
        self.loss_fn = make_crystal_loss(model, cfg)
        quantum_keys = tuple(getattr(model, "quantum_param_keys", ("q",)))
        self.named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.q_named, c_named = split_params(self.named, quantum_keys)
        self.quantum_keys = quantum_keys
        self.c_leaves = list(c_named.values())
        self.warm_opt = optim.make_optimizer(cfg.warmup_lr, schedule="none")
        self.warm_state = self.warm_opt.init(self.c_leaves)
        self.spsa_cfg = SPSAConfig(a=cfg.spsa_lr, c=cfg.spsa_delta, alpha=0.0, gamma=0.0)
        self.split = cfg.mode == "spsa-split"
        # the split mode's Adam starts fresh, as the JAX package's
        self.adam = optim.make_optimizer(cfg.warmup_lr, schedule="none")
        self.adam_state = self.adam.init(self.c_leaves)
        self._runners = {}

    def warmup_step(self) -> torch.Tensor:
        loss = self.loss_fn(self.gen)
        grads = torch.autograd.grad(loss, self.c_leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.c_leaves, grads)]
        updates, _ = self.warm_opt.update(grads, self.warm_state, self.c_leaves)
        optim.apply_updates(self.c_leaves, updates)
        return loss.detach()

    def spsa_step(self) -> torch.Tensor:
        # constant gains (alpha = gamma = 0): the step counter k^0 is 1
        if self.split:
            _, _, loss = spsa_split_step(self.loss_fn, self.named, 1.0, self.gen,
                                         self.spsa_cfg, self.adam, self.adam_state,
                                         quantum_keys=self.quantum_keys)
        else:
            _, loss = spsa_step(self.loss_fn, self.q_named, 1.0, self.gen, self.spsa_cfg)
        return loss

    def runner(self, stage: str):
        """The stage's step as it runs: a CapturedStep on the card (built at
        the first call), the eager step on the CPU."""
        if stage not in self._runners:
            step = self.warmup_step if stage == "warmup" else self.spsa_step
            on_card = next(self.model.parameters()).device.type == "cuda"
            self._runners[stage] = CapturedStep(step, self.gen) if on_card else step
        return self._runners[stage]

    def run(self, stage: str, n: int) -> torch.Tensor:
        step = self.runner(stage)
        trace = torch.empty(n, device=next(self.model.parameters()).device)
        for i in range(n):
            trace[i].copy_(step())
        return trace


def train_crystal(
    model: nn.Module,
    cfg: CrystalConfig,
    logger=None,
    params: Optional[dict] = None,
    device=None,
) -> Tuple[nn.Module, dict]:
    """Run (optional warmup ->) SPSA training on ``device`` (default: the
    card; raises without CUDA), in place; ``params`` (a JAX-layout tree, or
    None for the model's own weights) is where it starts. Returns ``(model,
    {"warmup_history": [...], "spsa_history": [...]})``."""
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"the model is on {on}; train on {device}")

    def log(msg):
        if logger is not None:
            logger.print(msg)

    if params is not None:
        model.load_state_dict(params_from_jax(params))
    gen = torch.Generator(device=on).manual_seed(cfg.seed + SAMPLE_SEED_OFFSET)
    trainer = CrystalTrainer(model, cfg, gen)

    warmup_history = []
    if cfg.warmup_epochs > 0:
        # classical-only Adam stage, quantum frozen (test_hqpinn_cg.py:180-199)
        t0 = time.time()
        warmup_history = trainer.run("warmup", cfg.warmup_epochs).tolist()
        log(f"classical warmup: {cfg.warmup_epochs} Adam epochs, "
            f"loss {warmup_history[0]:.4e} -> {warmup_history[-1]:.4e} "
            f"({time.time() - t0:.1f}s)")

    chunk = max(1, min(cfg.log_every, cfg.spsa_steps))
    history = []
    done = 0
    t0 = time.time()
    while done < cfg.spsa_steps:
        n = min(chunk, cfg.spsa_steps - done)
        history.extend(trainer.run("spsa", n).tolist())
        done += n
        log(f"[SPSA{'-split' if trainer.split else ''}] step {done}/{cfg.spsa_steps} "
            f"| crystal loss: {history[-1]:.4e} | {time.time() - t0:.1f}s")
    return model, {"warmup_history": warmup_history, "spsa_history": history}
