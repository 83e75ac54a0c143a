"""Command-line entry point of the port (twin of qcpinn_tpu/cli.py).

    python -m qcpinn_tpu_torch.cli train --problem diffusion --epochs 20000

``train`` takes the JAX CLI's flags, choices and defaults and follows its
``cmd_train`` step for step: pick a solver (DV or Classical), an ansatz
and a problem (diffusion, diffusion_sine, wave, klein_gordon, helmholtz,
navier_stokes), train (``train/loop.py::train``: on the card one captured
CUDA graph a step), evaluate relative L2 on the meshgrid, and write the
config, circuit diagram, checkpoint and plots into a timestamped run
directory. The DV solver's residual is the forward-mode operator
(``physics/operators_fwd.py``), the Hopfield baseline's the reverse-mode
one (``physics/operators.py``), which its batch coupling needs; the DV
circuit runs gate by gate under nested forward AD, as in the JAX CLI, so
no CUDA kernel of the package is on this path. ``--gradient-mode``
(backprop, parameter-shift, spsa, spsa-split), ``--shots`` and the three
``--noise-*`` flags are the hardware-fidelity modes (``train/loop.py``,
``train/hardware_grad.py``, ``train/spsa.py``, ``ops/measure.py``).

``main(argv, device=None)`` runs on the card and raises without CUDA;
``device="cpu"`` runs on the CPU. Not yet ported, each raising
``NotImplementedError`` that names its ROADMAP item: ``--solver CV``,
``--data-parallel``, and the ``crystal`` and ``cz`` subcommands.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

IN_DIMS = {"diffusion": 3, "diffusion_sine": 3, "wave": 2,
           "klein_gordon": 2, "helmholtz": 2, "navier_stokes": 3}
OUT_DIMS = {"navier_stokes": 3}  # [u, v, p]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qcpinn_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a PDE solver")
    t.add_argument("--problem", default="diffusion",
                   choices=["diffusion", "diffusion_sine", "wave", "klein_gordon",
                            "helmholtz", "navier_stokes"])
    t.add_argument("--solver", default="DV", choices=["DV", "CV", "Classical"])
    t.add_argument("--ansatz", default="cascade",
                   choices=["cascade", "layered", "alternate", "farhi",
                            "sim_circ_15", "cross_mesh", "rot_ring"])
    t.add_argument("--encoding", default="angle",
                   choices=["angle", "angle_pi", "amplitude"],
                   help="angle = RX(x_i) AngleEmbedding; angle_pi = "
                        "RX(pi*x_i) (pair with --ansatz rot_ring); "
                        "amplitude = normalized zero-padded")
    t.add_argument("--num-qubits", type=int, default=4)
    t.add_argument("--num-layers", type=int, default=1)
    t.add_argument("--cutoff-dim", type=int, default=6)
    t.add_argument("--cv-class", type=int, default=1, choices=[1, 2, 3])
    t.add_argument("--cv-readout", default=None, choices=["n", "x"])
    t.add_argument("--hidden-dim", type=int, default=50)
    t.add_argument("--epochs", type=int, default=20000)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--lr", type=float, default=5e-3)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--print-every", type=int, default=500)
    t.add_argument("--scheduler", default="plateau", choices=["plateau", "cosine", "none"])
    t.add_argument("--best-val", action="store_true",
                   help="track a fixed 512-point analytic-solution validation "
                        "set every logging chunk and keep the best params seen")
    t.add_argument("--shots", type=int, default=None,
                   help="shot-noise simulation mode (hardware fidelity); "
                        "takes effect with --gradient-mode parameter-shift "
                        "or spsa (backprop trains analytic, as the "
                        "reference's AER mode)")
    t.add_argument("--gradient-mode", default="backprop",
                   choices=["backprop", "parameter-shift", "spsa", "spsa-split"],
                   help="quantum gradient path (readme.md:166-171): "
                        "backprop = analytic simulator; parameter-shift = "
                        "shot-sampled shifted evaluations on value terms; "
                        "spsa = 2-eval zeroth-order updates on the FULL "
                        "pytree; spsa-split = SPSA on the quantum weights "
                        "+ Adam on the classical partition (the "
                        "reference's hardware recipe, "
                        "cg-hqpinn/...:727-748)")
    t.add_argument("--loss-balancer", default="none",
                   choices=["none", "ema", "uncertainty"],
                   help="adaptive loss balancing: ema = EMAWeights "
                        "ratio-to-average normalization; uncertainty = "
                        "trainable homoscedastic log-variances replacing the "
                        "static weights. Requires --gradient-mode backprop")
    t.add_argument("--noise-depolarizing", type=float, default=0.0)
    t.add_argument("--noise-readout", type=float, default=0.0)
    t.add_argument("--noise-per-gate", type=float, default=0.0,
                   help="depth-aware depolarizing rate applied per gate "
                        "per touched wire: <Z_w> damps by (1-p)^(gate "
                        "count on w), so error accumulates with circuit "
                        "depth like the reference's FakeSherbrooke device "
                        "noise (cg-hqpinn/...:183-196)")
    t.add_argument("--output-dir", default="runs")
    t.add_argument("--run-name", default=None)
    t.add_argument("--eval-grid", type=int, default=20)
    t.add_argument("--metrics-json", default="",
                   help="also write {command, config, metrics, final_loss, "
                        "trainable_params} to this JSON path")
    t.add_argument("--no-plots", action="store_true")
    t.add_argument("--data-parallel", action="store_true",
                   help="shard the collocation batch over all local devices")

    # not yet ported: main() refuses them, whatever their arguments
    sub.add_parser("crystal", help="phase-field crystal growth")
    sub.add_parser("cz", help="Czochralski two-phase pipeline")
    return p


def make_config(args):
    from .config import QCPINNConfig

    return QCPINNConfig(
        problem=args.problem,
        solver=args.solver,
        classic_network=(IN_DIMS[args.problem], args.hidden_dim,
                         OUT_DIMS.get(args.problem, 1)),
        num_qubits=args.num_qubits,
        num_quantum_layers=args.num_layers,
        q_ansatz=args.ansatz,
        encoding=args.encoding,
        cv_class=args.cv_class,
        cutoff_dim=args.cutoff_dim,
        cv_readout=args.cv_readout,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        print_every=args.print_every,
        scheduler=args.scheduler,
        shots=args.shots,
        gradient_mode=args.gradient_mode,
        loss_balancer=args.loss_balancer,
        noise_depolarizing=args.noise_depolarizing,
        noise_readout=args.noise_readout,
        noise_per_gate=args.noise_per_gate,
        output_dir=args.output_dir,
        run_name=args.run_name,
    )


def make_model(cfg, device):
    from .models import ClassicalSolver, DVSolver

    return {"DV": DVSolver, "Classical": ClassicalSolver}[cfg.solver](cfg, device=device)


def make_problem(problem: str, cfg):
    """(terms, operator, analytic_u, analytic_r) of ``problem``: the
    samplers, loss terms and residual operator of the JAX CLI's
    ``cmd_train`` (forward mode, or reverse mode for the Classical solver,
    whose Hopfield layer couples the batch)."""
    from .data import diffusion as dd
    from .physics import get_operator
    from .train.loop import TermSpec, diffusion_terms

    op_mode = "rev" if cfg.solver == "Classical" else "fwd"
    box = dd._box
    third = max(cfg.batch_size // 3, 1)
    twelfth = max(cfg.batch_size // 12, 1)
    if problem == "diffusion":
        terms = diffusion_terms(dd.gaussian_pulse_samplers(), cfg.batch_size,
                                cfg.loss_weights)
        return terms, get_operator("diffusion", op_mode), dd.u, dd.r_true
    if problem == "diffusion_sine":
        s = dd.sine_samplers()
        terms = {
            "res": TermSpec(s["res"], 2.0, cfg.batch_size, "residual"),
            "ic": TermSpec(s["ics"], 2.0, third, "value"),
            **{f"bc{i}": TermSpec(s[f"bc{i}"], 4.0, twelfth, "value")
               for i in range(1, 5)},
        }
        base_op = get_operator("diffusion", op_mode)

        def operator(apply, X):
            return base_op(apply, X, v_x=0.0, v_y=0.0)

        return terms, operator, dd.u_sine, None
    if problem == "navier_stokes":
        # Taylor-Green vortex oracle (data/navier_stokes.py)
        from .data import navier_stokes as ns

        s = ns.taylor_green_samplers()
        terms = {
            "res": TermSpec(s["res"], 2.0, cfg.batch_size, "residual"),
            "ic": TermSpec(s["ics"], 2.0, third, "value"),
            **{f"bc{i}": TermSpec(s[f"bc{i}"], 4.0, twelfth, "value")
               for i in range(1, 5)},
        }
        return terms, ns.residual_stack(get_operator("navier_stokes", op_mode)), ns.uvp, None

    def sin_wave(X):  # u = sin(x - 2t)
        return torch.sin(X[:, 1:2] - 2.0 * X[:, 0:1])

    def kg_u(X):
        return torch.sin(math.pi * X[:, 1:2]) * torch.cos(math.pi * X[:, 0:1])

    def hh_u(X):
        return torch.sin(math.pi * X[:, 0:1]) * torch.sin(math.pi * X[:, 1:2])

    def hh_forcing(X):
        return (1.0 - 2.0 * math.pi**2) * hh_u(X)

    def term(rows, func, weight, batch, kind="value"):
        return TermSpec(dd.Sampler(box(rows), func), weight, batch, kind)

    if problem == "wave":  # IC at t=0, zero residual in the domain
        terms = {
            "res": term([[0, 0], [1, 1]], dd.zero_target, 2.0, cfg.batch_size, "residual"),
            "ic": term([[0, 0], [0, 1]], sin_wave, 2.0, third),
            "bc": term([[0, 0], [1, 0]], sin_wave, 4.0, third),
        }
        return terms, get_operator("wave", op_mode), sin_wave, None
    if problem == "klein_gordon":
        terms = {
            "res": term([[0, 0], [1, 1]], dd.zero_target, 2.0, cfg.batch_size, "residual"),
            "ic": term([[0, 0], [0, 1]], kg_u, 2.0, third),
            "bc": term([[0, 0], [1, 0]], kg_u, 4.0, third),
        }
        return terms, get_operator("klein_gordon", op_mode), kg_u, None
    if problem == "helmholtz":
        terms = {
            "res": term([[0, 0], [1, 1]], hh_forcing, 2.0, cfg.batch_size, "residual"),
            "bc1": term([[0, 0], [1, 0]], hh_u, 4.0, third),
            "bc2": term([[0, 0], [0, 1]], hh_u, 4.0, third),
        }
        return terms, get_operator("helmholtz", op_mode), hh_u, None
    raise ValueError(problem)


def validation_set(terms, analytic_u, seed: int, device):
    """The fixed analytic-solution validation set of ``--best-val``: 256
    points from the residual term's box and 256 split over the value
    terms' (walls and IC), so 'best' params cannot favour the interior
    while the walls drift. Drawn from a generator of its own (seed
    10,000 + the run's)."""
    gen = torch.Generator(device=device).manual_seed(10_000 + seed)
    parts = [terms["res"].sampler.sample(gen, 256)[0]]
    value_terms = [t for t in terms.values() if t.kind == "value"]
    per = max(256 // max(len(value_terms), 1), 1)
    parts += [t.sampler.sample(gen, per)[0] for t in value_terms]
    X_val = torch.cat(parts, dim=0)
    return X_val, analytic_u(X_val), len(value_terms)


def cmd_train(args, device=None) -> int:
    from . import resolve_device
    from .models.nn_core import count_trainable
    from .train.loop import make_val_fn, train
    from .utils.checkpoint import save_checkpoint
    from .utils.evaluation import evaluate_relative_l2
    from .utils.logger import Logging

    device = resolve_device(device)
    if args.solver == "CV":
        raise NotImplementedError(
            "--solver CV is not yet ported (ROADMAP queue 1, the CV solver)")
    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel is not yet ported (ROADMAP queue 1, parallel)")
    cfg = make_config(args)
    model = make_model(cfg, device)
    logger = Logging(cfg.output_dir, cfg.run_name or f"{cfg.solver}-{cfg.q_ansatz}-{cfg.problem}")
    try:
        logger.dump_config(cfg)
        out_dir = logger.get_output_dir()
        if cfg.solver == "DV":
            # circuit diagram into the run dir (nn/DVPDESolver.py:144-158)
            from .utils.drawing import draw_circuit

            draw_circuit(model.circuit, out_dir)
            logger.print("circuit diagram written (circuit.txt / circuit.pdf)")

        terms, operator, analytic_u, analytic_r = make_problem(args.problem, cfg)
        val_fn = None
        if args.best_val:
            X_val, y_val, n_walls = validation_set(terms, analytic_u, cfg.seed, device)
            val_fn = make_val_fn(model, X_val, y_val)
            logger.print(
                f"best-val tracking on ({X_val.shape[0]}-point analytic set: "
                f"256 interior + {n_walls} wall/IC samplers)")

        model, history = train(model, cfg, terms, operator, logger=logger,
                               val_fn=val_fn, device=device)
        logger.print(f"trainable parameters: {count_trainable(model)}")

        ckpt = save_checkpoint(os.path.join(out_dir, "model"), model,
                               loss_history=history, config=cfg.to_dict(),
                               epoch=cfg.epochs)
        logger.print(f"checkpoint: {ckpt}")

        hi = [1.0, math.pi, math.pi] if args.problem == "navier_stokes" else None
        metrics = evaluate_relative_l2(
            model, analytic_u, analytic_r=analytic_r,
            operator=operator if analytic_r is not None else None,
            num=args.eval_grid, hi=hi, dims=IN_DIMS[args.problem], device=device,
        )
        for k, v in metrics.items():
            logger.print(f"{k}: {v:.4f}")
        if args.metrics_json:
            # the argv actually parsed (main(argv=...) callers have a
            # foreign sys.argv)
            arg_list = args._argv if args._argv is not None else sys.argv[1:]
            with open(args.metrics_json, "w") as f:
                json.dump({
                    "command": "python -m qcpinn_tpu_torch.cli " + " ".join(arg_list),
                    "config": cfg.masked_dict(),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "final_loss": float(history[-1]) if history else None,
                    "trainable_params": count_trainable(model),
                }, f, indent=1)
            logger.print(f"metrics artifact written to {args.metrics_json}")
            if not args.no_plots:
                from .utils.plotting import draw_contourf_grid, plot_loss_history

                plot_loss_history(history, out_dir)
                # the contour grid is the scalar-u (t, x, y) layout
                if args.problem in ("diffusion", "diffusion_sine"):
                    draw_contourf_grid(model, analytic_u, out_dir, per_timestep=True,
                                       device=device)
                logger.print("plots written")
    finally:
        logger.close()
    return 0


def main(argv=None, device=None) -> int:
    """Parse ``argv`` (default: the command line) and run the subcommand on
    ``device`` (default: the card)."""
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    args._argv = list(argv) if argv is not None else None
    if args.command == "train":
        if rest:
            parser.error(f"unrecognized arguments: {' '.join(rest)}")
        return cmd_train(args, device)
    if args.command == "crystal":
        raise NotImplementedError(
            "cli crystal is not yet ported (ROADMAP queue 1, crystal and SI-gated)")
    raise NotImplementedError(
        "cli cz is not yet ported (ROADMAP queue 1, Czochralski flagship)")


if __name__ == "__main__":
    sys.exit(main())
