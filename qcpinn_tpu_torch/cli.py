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

``cz`` runs the two-phase Czochralski pipeline (``train/cz_pipeline.py``)
with the JAX CLI's flags: ``--phase pretrain|finetune|eval`` with a
checkpoint handoff (the JAX bundle format, with the normalization stats as
sidecar and in the manifest), ``--quick-check``, ``--time-budget``, and
the field maps of ``eval``.

    python -m qcpinn_tpu_torch.cli cz --phase pretrain --data data/cz_melt_raw.txt \
        --save runs/cz --batch-size 256 --physics-normalize balanced

``main(argv, device=None)`` runs on the card and raises without CUDA;
``device="cpu"`` runs on the CPU. Not yet ported, each raising
``NotImplementedError`` that names its ROADMAP item: ``--solver CV``,
``--data-parallel`` and ``cz --amp > 1``, and the ``crystal`` subcommand.
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

    # not yet ported: main() refuses it, whatever its arguments
    sub.add_parser("crystal", help="phase-field crystal growth")

    c = sub.add_parser("cz", help="Czochralski two-phase pipeline")
    c.add_argument("--phase", choices=["pretrain", "finetune", "eval"], required=True)
    c.add_argument("--data", required=True)
    c.add_argument("--save", default="",
                   help="checkpoint path (required for pretrain/finetune)")
    c.add_argument("--load", default="")
    c.add_argument("--n-qubits", type=int, default=16)
    c.add_argument("--n-layers", type=int, default=2)
    c.add_argument("--epochs", type=int, default=2000)
    c.add_argument("--batch-size", type=int, default=16)
    c.add_argument("--lr", type=float, default=1e-3)
    # defaults track the reference flagship CLI (CG...16qubits.py:627-648)
    c.add_argument("--re", type=float, default=15.0)
    c.add_argument("--pr", type=float, default=28.463)
    c.add_argument("--gr", type=float, default=8000.0)
    c.add_argument("--physics-weight", type=float, default=0.05)
    c.add_argument("--physics-warmup", type=int, default=150)
    c.add_argument("--physics-ramp", type=int, default=400)
    c.add_argument("--log-every", type=int, default=10)
    c.add_argument("--physics-normalize", default="reference",
                   choices=["reference", "balanced", "coupled"],
                   help="'reference' = the EMAWeights ratio-to-average "
                        "scheme (collapses the data fit when raw residuals "
                        "dwarf the data loss); 'balanced' = scale physics "
                        "to the data-loss magnitude via absolute EMAs; "
                        "'coupled' = trainable CoupledAdaptiveWeighting "
                        "(modified_qpinn_cg.py:142-156, see --coupled-ratio)")
    c.add_argument("--coupled-ratio", type=float, default=100.0,
                   help="data:physics noise-scale ratio for "
                        "--physics-normalize coupled")
    c.add_argument("--field-weights", default=None,
                   help="comma-separated data-loss weights over "
                        "u_r,u_z,u_theta,p,T (normalized to mean 1)")
    c.add_argument("--time-budget", type=float, default=0.0,
                   help="pretrain wall-clock budget in minutes (0 = none): "
                        "stop after the epoch that crosses it and save the "
                        "final checkpoint")
    c.add_argument("--shots", type=int, default=4096)
    c.add_argument("--calib-size", type=int, default=8)
    c.add_argument("--train-scope", default="head", choices=["head", "full"])
    c.add_argument("--noise-depolarizing", type=float, default=0.0,
                   help="noisy-simulator finetune (the reference's ibm-sim "
                        "phase with a FakeSherbrooke stand-in)")
    c.add_argument("--noise-readout", type=float, default=0.0)
    c.add_argument("--noise-per-gate", type=float, default=0.0,
                   help="depth-aware per-gate depolarizing for the "
                        "finetune phase (see train --noise-per-gate)")
    c.add_argument("--seed", type=int, default=42)
    c.add_argument("--save-every", type=int, default=0)
    c.add_argument("--data-parallel", action="store_true",
                   help="pretrain/eval data-parallel over all local devices")
    c.add_argument("--trunk-width", type=int, default=128,
                   help="classical trunk width (reference: 128); use the same "
                        "width for --load/eval")
    c.add_argument("--amp", type=int, default=1,
                   help="amplitude-shard the circuit's 2^n statevector over "
                        "this many devices")
    c.add_argument("--quick-check", action="store_true",
                   help="2-epoch, tiny-model smoke run")
    c.add_argument("--output-dir", default="runs")
    c.add_argument("--no-plots", action="store_true")
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


def cz_config(args):
    """The ``CzConfig`` of ``cli cz``'s parsed flags."""
    from .train.cz_pipeline import CzConfig

    return CzConfig(
        n_qubits=args.n_qubits,
        n_layers=args.n_layers,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        re=args.re,
        pr=args.pr,
        gr=args.gr,
        physics_weight=args.physics_weight,
        physics_warmup=args.physics_warmup,
        physics_ramp=args.physics_ramp,
        physics_normalize=args.physics_normalize,
        coupled_ratio=args.coupled_ratio,
        log_every=args.log_every,
        finetune_epochs=args.epochs if args.phase == "finetune" else 100,
        shots=args.shots,
        calib_size=args.calib_size,
        train_scope=args.train_scope,
        noise_depolarizing=args.noise_depolarizing,
        noise_readout=args.noise_readout,
        noise_per_gate=args.noise_per_gate,
        field_weights=(tuple(float(v) for v in args.field_weights.split(","))
                       if args.field_weights else None),
    )


def _checkpoint_handoff(args):
    """(stats, manifest) restored from ``--load`` before the data is read:
    the stats from the sidecar (or, if it is lost, the manifest) for eval
    and finetune, so the data is normalized in the space the model was
    trained in; then the architecture guard, which fails loudly on a width,
    qubit or layer mismatch (the leaf count alone cannot tell)."""
    from .data.cz_loader import DataStats

    ckpt_stats, manifest = None, {}
    if not args.load:
        return ckpt_stats, manifest
    if os.path.exists(args.load + ".json"):
        with open(args.load + ".json") as f:
            manifest = json.load(f)
    if args.phase in ("eval", "finetune"):
        sidecar = args.load + ".stats.json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                ckpt_stats = DataStats.from_dict(json.load(f))
        elif manifest.get("stats"):
            ckpt_stats = DataStats.from_dict(manifest["stats"])
    ckpt_config = manifest.get("config") or {}
    for field, got in (("trunk_width", args.trunk_width), ("n_qubits", args.n_qubits),
                       ("n_layers", args.n_layers)):
        saved = ckpt_config.get(field)
        if saved is not None and int(saved) != int(got):
            flag = "--" + field.replace("_", "-")
            raise SystemExit(f"checkpoint {args.load} was trained with {flag} "
                             f"{saved}; rerun with {flag} {saved} (got {got})")
    return ckpt_stats, manifest


def cmd_cz(args, device=None) -> int:
    from . import resolve_device
    from .utils.logger import Logging

    device = resolve_device(device)
    if args.amp > 1 or args.data_parallel:
        raise NotImplementedError(
            "the Czochralski flagship's --data-parallel and --amp > 1 are not yet "
            "ported (ROADMAP queue 1, parallel)")
    logger = Logging(args.output_dir, f"cz-{args.phase}")
    try:
        return run_cz(args, device, logger)
    finally:
        logger.close()


def run_cz(args, device, logger) -> int:
    """The body of ``cmd_cz`` (JAX ``cmd_cz``, cli.py:529-764)."""
    from .bridge import params_from_jax
    from .data.cz_loader import choose_calibration_subset, load_cz_data
    from .models.czochralski import Hybrid16QPINN
    from .models.nn_core import count_trainable
    from .train.cz_pipeline import run_finetune, run_pretrain
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    if args.quick_check:
        args.epochs = 2
        args.n_qubits = min(args.n_qubits, 4)
        args.n_layers = 1
        args.batch_size = 4
        logger.print("quick-check mode: 2 epochs, tiny circuit")

    ckpt_stats, _ = _checkpoint_handoff(args)
    X, Y, stats = load_cz_data(args.data, stats=ckpt_stats)
    if ckpt_stats is not None:
        logger.print("data normalized with the checkpoint's stats sidecar")
    logger.print(f"loaded {X.shape[0]} nodes; stats: {stats.to_json()}")

    cfg = cz_config(args)
    model = Hybrid16QPINN(n_qubits=cfg.n_qubits, n_layers=cfg.n_layers,
                          remat=cfg.effective_remat, width=args.trunk_width,
                          seed=cfg.seed, device=device)

    if args.phase in ("pretrain", "finetune") and not args.save:
        raise SystemExit(f"{args.phase} phase requires --save")
    if args.time_budget and args.phase != "pretrain":
        logger.print(f"WARNING: --time-budget only applies to the pretrain phase; "
                     f"ignored for --phase {args.phase}")

    def load_params():
        # cz bundles store params only: a resume gets a fresh optimizer, as
        # in the reference (CG_HQPINN_IBMtest_16qubits.py:443-455)
        return load_checkpoint(args.load, model)

    if args.phase == "eval":
        # field-wise rel-L2 and val MSE over the full node set
        from .utils.evaluation import evaluate_cz_fields

        if not args.load:
            raise SystemExit("eval phase requires --load with a checkpoint")
        model.load_state_dict(params_from_jax(load_params()["bundle"]["params"]))
        metrics, pred = evaluate_cz_fields(model, X, Y, return_pred=True, device=device)
        for k, v in metrics.items():
            logger.print(f"{k}: {v:.6e}")
        if not args.no_plots:
            # truth-vs-prediction field maps over the node cloud
            from .utils.plotting import plot_field_scatter

            p = plot_field_scatter(X, Y, ["u_r", "u_z", "u_theta", "p", "T"],
                                   logger.get_output_dir(), name="eval_fields", pred=pred)
            logger.print(f"field maps written to {p}")
        logger.print(json.dumps(metrics))
        return 0

    if args.phase == "pretrain":
        def ckpt_fn(params, epoch, history):
            save_checkpoint(args.save, params, loss_history=history,
                            stats=stats.to_dict(), config=vars(args), epoch=epoch)

        warm = None
        if args.load:
            # warm start from a checkpoint's params (fresh optimizer and
            # schedule: the cz format holds no optimizer state)
            restored = load_params()
            warm = restored["bundle"]["params"]
            logger.print(f"warm start from {args.load}")
            saved_stats = restored.get("stats")
            if saved_stats and saved_stats != stats.to_dict():
                logger.print(
                    "WARNING: warm-start checkpoint stats differ from the "
                    "file-derived stats of --data; the warm-started params "
                    "will be reinterpreted in the new normalized space")
        model, history = run_pretrain(
            model, X, Y, stats, cfg, logger=logger, params=warm,
            checkpoint_fn=ckpt_fn if args.save_every else None,
            save_every=args.save_every, time_budget_s=args.time_budget * 60.0)
        # len(history) = the epochs actually run (a --time-budget stop may
        # end the run early)
        save_checkpoint(args.save, model, loss_history=history, stats=stats.to_dict(),
                        config=vars(args), epoch=len(history))
        logger.print(f"pretrain checkpoint saved to {args.save}.npz (+ stats sidecar)")
        logger.print(f"trainable parameters: {count_trainable(model)}")
        return 0

    if not args.load:
        raise SystemExit("finetune phase requires --load with the pretrain checkpoint")
    params = load_params()["bundle"]["params"]
    model.load_state_dict(params_from_jax(params))
    # the pre-finetune diagnostic suite (cg-hqpinn/...:515-587)
    if not args.no_plots:
        from .utils.plotting import plot_cz_diagnostics

        x_c, _ = choose_calibration_subset(X, Y, cfg.calib_size)
        plot_cz_diagnostics(model, X, Y, logger.get_output_dir(), x_calib=x_c,
                            device=device)
        logger.print("diagnostic plots written (data_fields/calib_coverage/"
                     "initial_pred_vs_gt/quantum_weights_hist)")
    model, history = run_finetune(model, None, X, Y, stats, cfg, logger=logger)
    save_checkpoint(args.save, model, loss_history=history, stats=stats.to_dict(),
                    config=vars(args), epoch=cfg.finetune_epochs)
    logger.print(f"finetune checkpoint saved to {args.save}.npz")
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
    if args.command == "cz":
        if rest:
            parser.error(f"unrecognized arguments: {' '.join(rest)}")
        return cmd_cz(args, device)
    raise NotImplementedError(
        "cli crystal is not yet ported (ROADMAP queue 1, crystal and SI-gated)")


if __name__ == "__main__":
    sys.exit(main())
