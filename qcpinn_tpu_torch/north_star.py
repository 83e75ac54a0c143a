"""North-star run of the port: the 16-qubit cross_mesh QCPINN on
convection-diffusion, on the card (twin of ``examples/north_star.py``).

Trains against the consistent forcing ``r_true``. The defaults are the JAX
script's: 16 qubits, cross_mesh, B = 256 residual points plus five value
walls of 85, hidden 64, Fourier map 32 (scale 4), skip 32, an additive
8-unit RBF head (width 8) with centers drawn where |forcing| is large,
pulse-focused residual sampling, and classical-then-quantum staging:
stage 1 trains with a zeroed quantum block (residual by a second-order
forward jet, ``physics/jet.py``), then the decoder's quantum-feature
columns are scaled by ``--z-rescale`` and stage 2 trains the full model at
``lr / 5`` with the tangent-stream residual (n >= 10). Each stage is Adam
with global-norm clipping and a cosine horizon; each runs one warm-up
chunk, then chunks until its wall-clock budget or its step horizon.

    python -m qcpinn_tpu_torch.north_star [--backend loop] [--minutes 4.5]

``--backend`` picks the evolution engine (ops/backends.py; ``auto`` picks
``loop``, the CUDA gate-table kernels, at 16 qubits on the card, ``block``
the plain block engine, ``xla`` the gate-by-gate circuit). On the card
each stage's step is captured in a CUDA graph and replayed
(``train/loop.py``); evaluation runs eagerly. Prints one JSON line with the
JAX script's keys and the card's name and power limit. Unlike the JAX
script, ``points_per_sec`` and the stage seconds count only the timed
steps (the warm-up chunk of each stage is outside both), and numbers are
not rounded.

``--solver plain`` trains the plain ``DVSolver`` (encoder MLP straight to
the angles, no Fourier map, skip or RBF head) in one stage, as the JAX
script does: the tangent-stream residual at n >= 10, below that the
forward-mode residual on the plain ``block`` engine.
``--solver classical`` (Hopfield) is not yet ported (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import zlib
from typing import Callable, Optional

import torch

from . import resolve_device
from .bench import card
from .config import QCPINNConfig
from .data import diffusion as dd
from .models import nn_core as nc
from .models.dv_fourier import DVFourierSolver, ZeroQ
from .models.dv_solver import DVSolver
from .physics.jet import diffusion_jet
from .physics.operators_fwd import diffusion_operator_fwd
from .physics.streams import dv_diffusion_residual_streams
from .train import optim as topt
from .train.loop import TermSpec, make_train_step
from .utils.evaluation import evaluate_relative_l2

# engines with first-order reverse AD only: no forward-mode residual
REVERSE_ONLY = ("loop", "unrolled", "block_kernel")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qubits", type=int, default=16)
    ap.add_argument("--ansatz", default="cross_mesh")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--minutes", type=float, default=4.5)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--total-steps", type=int, default=700,
                    help="cosine horizon and step limit of the last stage")
    ap.add_argument("--plain", action="store_true", help="use the plain DVSolver")
    ap.add_argument("--solver", default=None, choices=["fourier", "plain", "classical"])
    ap.add_argument("--backend", default="auto",
                    help="evolution engine: auto|block|block_kernel|loop|unrolled|xla")
    ap.add_argument("--focus-frac", type=float, default=0.5,
                    help="fraction of residual points drawn around the pulse")
    ap.add_argument("--focus-sigma", type=float, default=0.12)
    ap.add_argument("--supervised", action="store_true",
                    help="ablation: fit u directly instead of the PDE residual")
    ap.add_argument("--mapping", type=int, default=32)
    ap.add_argument("--ff-scale", type=float, default=4.0)
    ap.add_argument("--skip-dim", type=int, default=32)
    ap.add_argument("--no-quantum", action="store_true",
                    help="ablation: identity quantum block (z = angles)")
    ap.add_argument("--rbf", type=int, default=8,
                    help="additive Gaussian-RBF head units (0 = off)")
    ap.add_argument("--rbf-width", type=float, default=8.0)
    ap.add_argument("--stage1-minutes", type=float, default=1.5,
                    help="stage 1 (zeroed quantum block) budget; 0 = one stage")
    ap.add_argument("--stage1-steps", type=int, default=40000)
    ap.add_argument("--z-rescale", type=float, default=1e-2,
                    help="scale on the decoder's quantum-feature columns at "
                    "the stage-1 -> stage-2 handoff")
    ap.add_argument("--artifact", default="",
                    help="also write {command, result} JSON to this path")
    ap.add_argument("--lr2", type=float, default=None,
                    help="stage-2 lr (default lr/5)")
    return ap.parse_args(argv)


class IdentityQ:
    """``--no-quantum``: z = the angles, no circuit."""

    def apply(self, qp, x):
        return x


def make_terms(args) -> dict:
    box = dd._box
    third = max(args.batch // 3, 1)
    if args.focus_frac > 0.0:
        res_sampler = dd.pulse_residual_sampler(
            frac=args.focus_frac, sigma=args.focus_sigma, func=dd.r_true)
    else:
        res_sampler = dd.Sampler(box([[0, 0, 0], [1, 1, 1]]), dd.r_true, "res")
    if args.supervised:
        if isinstance(res_sampler, dd.MixtureSampler):
            sup = dataclasses.replace(res_sampler, func=dd.u)
        else:
            sup = dd.Sampler(box([[0, 0, 0], [1, 1, 1]]), dd.u, "sup")
        res_term = TermSpec(sup, 1.0, args.batch, "value")
    else:
        res_term = TermSpec(res_sampler, 1.0, args.batch, "residual")

    def wall(rows):
        return TermSpec(dd.Sampler(box(rows), dd.u), 10.0, third, "value")

    return {
        "res": res_term,
        "ic": wall([[0, 0, 0], [0, 1, 1]]),
        "bcx0": wall([[0, 0, 0], [1, 0, 1]]),
        "bcx1": wall([[0, 1, 0], [1, 1, 1]]),
        "bcy0": wall([[0, 0, 0], [1, 1, 0]]),
        "bcy1": wall([[0, 0, 1], [1, 1, 1]]),
    }


def rbf_centers(args, device) -> Optional[torch.Tensor]:
    """RBF centers drawn from 4096 uniform points with probability
    proportional to |r_true| (seeds 123 and 124, as in the JAX script;
    torch's generators give other numbers than jax.random)."""
    if args.rbf <= 0:
        return None
    gen = torch.Generator(device=device).manual_seed(123)
    Xp = torch.rand((4096, 3), generator=gen, device=device)
    gen_c = torch.Generator(device=device).manual_seed(124)
    return nc.rbf_centers_from_samples(gen_c, Xp, dd.r_true(Xp), args.rbf)


def solver_name(args) -> str:
    return args.solver or ("plain" if args.plain else "fourier")


def build_model(args, device):
    """(config, model, use_streams, stage-2 engine name) for ``args``."""
    solver = solver_name(args)
    if solver == "classical":
        raise NotImplementedError(
            "--solver classical (Hopfield) is not yet ported (ROADMAP queue 1 item 10)")
    cfg = QCPINNConfig(
        num_qubits=args.qubits,
        num_quantum_layers=args.layers,
        q_ansatz=args.ansatz,
        classic_network=(3, args.hidden, 1),
        batch_size=args.batch,
        lr=args.lr,
        seed=args.seed,
        scheduler="cosine",
        epochs=args.total_steps,
    )
    if solver == "fourier":
        model = DVFourierSolver(
            cfg, mapping_size=args.mapping, ff_scale=args.ff_scale,
            skip_dim=args.skip_dim, rbf_count=args.rbf, rbf_width=args.rbf_width,
            rbf_centers=rbf_centers(args, device), device=device,
        )
    else:
        model = DVSolver(cfg, device=device)
    # tangent-stream residuals at high qubit counts (nested AD through a
    # 2^16 state would cap the batch); decided before the engine, since a
    # forward-mode residual through the circuit needs the block engine
    use_streams = not args.no_quantum and not args.supervised and args.qubits >= 10
    backend = args.backend
    need_fwd_ad = not args.supervised and not use_streams
    if need_fwd_ad and backend in ("auto", *REVERSE_ONLY):
        if backend != "auto":
            print(f"[north-star] backend {backend!r} is reverse-only; the "
                  "residual path needs forward-mode AD — using 'block'")
        backend = "block"
    return cfg, model, use_streams, backend


def set_engine(model, args, backend: str) -> None:
    """The stage-2 quantum block: identity (``--no-quantum``), the
    gate-by-gate circuit (``xla``) or an engine from ops/backends.py."""
    if args.no_quantum:
        model._fused = IdentityQ()
    elif backend == "xla":
        model._fused = None
    else:
        model.use_fused(backend)


@dataclasses.dataclass
class Stage:
    """One Adam stage of the run (:func:`make_stage`): the model's trainable
    tensors, the optimizer and plateau state, the stage's sample stream, and
    ``make_train_step``'s two steps. ``run(n)`` takes n steps through
    ``run_steps`` (on the card, one captured CUDA graph replayed a step) and
    returns the metric trace; ``step()`` takes one eager step (the plain
    version) and returns its metrics."""

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


def make_stage(model, cfg, args, terms, label: str, backend: str = "block",
               use_streams: bool = False, optimizer=None,
               residual_fn=None) -> Stage:
    """Set ``model`` up for one stage and build its training state.
    ``stage1``: the zeroed quantum block (the decoder sees z = 0, so the
    circuit never runs and the z-columns of the first post layer get zero
    gradient), the residual by the second-order forward jet
    (``physics/jet.py``), ``args.lr``, horizon ``--stage1-steps``.
    ``stage2``: the circuit on ``backend``, lr ``--lr2`` (default lr / 5);
    ``train`` (the one stage): the circuit at ``args.lr``; both with
    horizon ``--total-steps`` and the tangent-stream residual when
    ``use_streams``. A given ``residual_fn(X) -> (u, residual)`` replaces
    the stage's own (its plain version, say, the nested jvps of
    ``diffusion_operator_fwd``). Each stage is clip + cosine Adam (or
    ``optimizer``) with a sample stream of its own."""
    if label == "stage1":
        model._fused = ZeroQ(cfg.num_qubits)
        lr, horizon = args.lr, args.stage1_steps
        if residual_fn is None:
            residual_fn = lambda X: diffusion_jet(model, X)  # noqa: E731
    else:
        set_engine(model, args, backend)
        lr = args.lr if label == "train" else (
            args.lr2 if args.lr2 is not None else args.lr / 5.0)
        horizon = args.total_steps
        if use_streams and residual_fn is None:
            residual_fn = lambda X: dv_diffusion_residual_streams(model, X)  # noqa: E731
    optimizer = optimizer or topt.make_optimizer(lr, grad_clip=1.0, schedule="cosine",
                                                 epochs=horizon)
    params = [p for p in model.parameters() if p.requires_grad]
    step_fn, run_steps = make_train_step(
        model, diffusion_operator_fwd, terms, optimizer, cfg,
        residual_fn=residual_fn, fuse_value_terms=True,
    )
    return Stage(label, horizon, params, optimizer.init(params),
                 topt.plateau_init(model.device),
                 torch.Generator(device=model.device).manual_seed(zlib.crc32(label.encode())),
                 step_fn, run_steps)


def run_phase(stage: Stage, budget_s, chunk):
    """One stage: a warm-up chunk (kernel builds, allocator, cuBLAS handles,
    the capture) outside the budget, then chunks until the wall-clock
    budget or the stage's horizon. Returns (steps done, timed steps, timed
    seconds, the loss of every step)."""
    losses = stage.run(chunk)["loss"].tolist()
    done, timed = chunk, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget_s and done < stage.horizon:
        losses += stage.run(chunk)["loss"].tolist()
        done += chunk
        timed += chunk
        if (timed // chunk) % 5 == 0:
            print(f"[{stage.label}] step {done}: loss={losses[-1]:.3e} "
                  f"elapsed={time.perf_counter() - t0:.0f}s", flush=True)
    return done, timed, time.perf_counter() - t0, losses


def run(args, device=None) -> dict:
    """The north-star run on ``device`` (default: the card); returns the
    result the script prints."""
    device = resolve_device(device)
    cfg, model, use_streams, backend = build_model(args, device)
    terms = make_terms(args)
    budget = args.minutes * 60.0
    stage_info = None
    solver = solver_name(args)
    if args.stage1_minutes > 0 and solver == "fourier" and not args.no_quantum:
        s1 = make_stage(model, cfg, args, terms, "stage1")
        d1, n1, t1, l1 = run_phase(s1, min(args.stage1_minutes * 60.0, budget),
                                   max(args.chunk, 500))
        # handoff: damp the decoder's quantum-feature columns so switching
        # the circuit on perturbs the converged fit smoothly
        with torch.no_grad():
            model.post[0].weight[:, : cfg.num_qubits] *= args.z_rescale
        s2 = make_stage(model, cfg, args, terms, "stage2", backend, use_streams)
        d2, n2, t2, l2 = run_phase(s2, budget - t1, args.chunk)
        done, timed, train_time, losses = d1 + d2, n2, t1 + t2, l1 + l2
        stage_info = {"stage1_steps": d1, "stage1_seconds": t1,
                      "stage2_steps": d2, "stage2_timed_steps": n2,
                      "stage2_seconds": t2}
    else:
        stage = make_stage(model, cfg, args, terms, "train", backend, use_streams)
        done, timed, train_time, losses = run_phase(stage, budget, args.chunk)

    seconds = stage_info["stage2_seconds"] if stage_info else train_time
    if use_streams:  # at high qubit counts the residual eval rides streams too
        def eval_operator(_apply, X):
            return dv_diffusion_residual_streams(model, X)
    else:
        eval_operator = diffusion_operator_fwd
    metrics = evaluate_relative_l2(
        model, dd.u, analytic_r=dd.r_true, operator=eval_operator, num=20,
        batch=min(4096 if args.qubits < 10 else 512, 8 * args.batch),
        device=device,
    )
    result = {
        "qubits": args.qubits,
        "ansatz": args.ansatz,
        "solver": solver,
        "focus_frac": args.focus_frac,
        "steps": done,
        "train_seconds": train_time,
        "final_loss": losses[-1] if losses else None,
        "losses_finite": all(math.isfinite(v) for v in losses),
        "rel_l2_u": metrics["rel_l2_u_percent"] / 100.0,
        "rel_l2_r": metrics.get("rel_l2_r_percent", None),
        # the quantum train step's rate over its timed steps
        "points_per_sec": timed * args.batch / max(seconds, 1e-9),
        "backend": type(model.qblock).__name__,
    }
    if stage_info:
        result.update(stage_info)
    return result


def main(argv=None):
    args = parse_args(argv)
    result = run(args)
    info = card()
    result["name"], result["power_limit"] = info["name"], info["power_limit"]
    print(json.dumps(result))
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump({"command": "python -m qcpinn_tpu_torch.north_star "
                       + " ".join(sys.argv[1:]), "result": result}, f, indent=1)


if __name__ == "__main__":
    main()
