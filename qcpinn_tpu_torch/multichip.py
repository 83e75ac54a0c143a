"""Multi-device QCPINN training walkthrough: the ('data', 'amp') mesh (twin
of examples/multichip.py).

Runs the same tangent-streams diffusion train step three ways,
single-device, amp-sharded per-gate engine and amp-sharded block engine,
and prints each one's per-step losses and the largest drift from the
single-device run (the sharded engines are exact, not approximations).

One process a device: under ``torchrun`` on the cards,

    torchrun --nproc-per-node 8 -m qcpinn_tpu_torch.multichip --amp 4

or as a gloo world of ``--devices`` processes on the CPU:

    python -m qcpinn_tpu_torch.multichip --device cpu --devices 8 --qubits 8 --steps 5
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for a gloo world on the CPU; default the card "
                         "(cuda:LOCAL_RANK under torchrun)")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the CPU world (--device cpu without torchrun)")
    ap.add_argument("--amp", type=int, default=4,
                    help="statevector ('tensor') parallel degree; the rest of "
                         "the world becomes the data axis")
    ap.add_argument("--qubits", type=int, default=8)
    ap.add_argument("--ansatz", default="cross_mesh")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    return ap.parse_args(argv)


def run(args) -> dict:
    """The three runs on this rank; every rank returns the same losses."""
    import torch

    from .config import QCPINNConfig
    from .data import gaussian_pulse_samplers
    from .models import DVSolver
    from .parallel import make_mesh
    from .physics.streams import dv_diffusion_residual_streams
    from .train import diffusion_terms, make_train_step
    from .train import optim as topt

    mesh = make_mesh(amp=args.amp, device=args.device)
    dev = mesh.device
    say = print if mesh.is_main else (lambda *a, **k: None)
    say(f"mesh: {mesh.shape} on {dev} ({mesh.backend})")
    cfg = QCPINNConfig(
        num_qubits=args.qubits, num_quantum_layers=1, q_ansatz=args.ansatz,
        classic_network=(3, 24, 1), batch_size=args.batch_size, epochs=1,
        lr=1e-3, seed=0, scheduler="none",
    )
    terms = diffusion_terms(gaussian_pulse_samplers(), cfg.batch_size)

    def one(label, model, use_mesh):
        optimizer = topt.make_optimizer(cfg.lr, grad_clip=1.0, schedule="none")
        params = [p for p in model.parameters() if p.requires_grad]
        _, run_steps = make_train_step(
            model, None, terms, optimizer, cfg, mesh=mesh if use_mesh else None,
            residual_fn=lambda X: dv_diffusion_residual_streams(model, X),
            fuse_value_terms=True)
        t0 = time.time()
        _, _, trace = run_steps(params, optimizer.init(params), topt.plateau_init(dev),
                                torch.Generator(device=dev).manual_seed(1), args.steps)
        losses = trace["loss"].tolist()
        say(f"{label:>22}: losses {[f'{v:.5f}' for v in losses]}  "
            f"({time.time() - t0:.1f}s incl. warm-up)")
        return losses

    single = one("single-device", DVSolver(cfg, device=dev), False)
    gate = one("amp-sharded (gate)",
               DVSolver(cfg, device=dev).use_sharded(mesh, backend="gate"), True)
    block = one("amp-sharded (block)",
                DVSolver(cfg, device=dev).use_sharded(mesh, backend="block"), True)
    drift = max(max(abs(a - b) for a, b in zip(gate, single)),
                max(abs(a - b) for a, b in zip(block, single)))
    say(f"max trajectory drift vs single-device: {drift:.2e} "
        f"(exact sharding: both engines reproduce the same training)")
    return {"mesh": mesh.shape, "single": single, "gate": gate, "block": block,
            "drift": drift}


def main(argv=None) -> int:
    import os

    args = parse_args(argv)
    if args.device == "cpu" and "RANK" not in os.environ:
        from . import multichip  # this module by name, also under ``python -m``
        from .parallel.mesh import run_cpu_world

        run_cpu_world(args.devices, multichip.run, args)
    else:
        import torch.distributed as dist

        run(args)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
