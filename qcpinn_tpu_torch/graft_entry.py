"""Driver entry points (twin of __graft_entry__.py).

- ``entry()``: the forward of the flagship model (the 12-qubit cross_mesh
  DV solver, the benchmark configuration) and its inputs, for a one-device
  check.
- ``dryrun_multichip(n)``: the FULL train step (sample -> forward -> PDE
  residual -> weighted loss -> grad -> clip -> Adam -> plateau scheduler)
  on an n-rank ('data', 'amp') mesh, the collocation batch split over
  'data', ONE step at tiny shapes, on a gloo world of n CPU processes.

    python -m qcpinn_tpu_torch.graft_entry
"""

from __future__ import annotations


def entry(device=None):
    """``(fn, args)``: the 12q cross_mesh ``DVSolver`` and a batch of 256
    points on ``device`` (default: the card)."""
    import torch

    from .config import QCPINNConfig
    from .models import DVSolver

    cfg = QCPINNConfig(num_qubits=12, num_quantum_layers=1, q_ansatz="cross_mesh",
                       classic_network=(3, 50, 1), seed=42)
    model = DVSolver(cfg, device=device)
    x = torch.rand((256, 3), generator=torch.Generator().manual_seed(1)).to(model.device)
    return model, (x,)


def amp_for(n_devices: int) -> int:
    """JAX's choice: the 'amp' axis where it divides the world (4 from 8
    devices, 2 from 4), else pure data parallelism."""
    if n_devices % 4 == 0 and n_devices >= 8:
        return 4
    if n_devices % 2 == 0 and n_devices >= 4:
        return 2
    return 1


def _one_step(model, cfg, terms, mesh, residual_fn):
    import math

    import torch

    from .physics import diffusion_operator
    from .train import make_train_step
    from .train import optim as topt

    optimizer = topt.make_optimizer(cfg.lr, grad_clip=cfg.effective_grad_clip)
    params = [p for p in model.parameters() if p.requires_grad]
    _, run_steps = make_train_step(model, diffusion_operator, terms, optimizer, cfg,
                                   mesh=mesh, residual_fn=residual_fn,
                                   fuse_value_terms=True)
    _, _, trace = run_steps(params, optimizer.init(params), topt.plateau_init(mesh.device),
                            torch.Generator(device=mesh.device).manual_seed(1), 1)
    loss = float(trace["loss"][-1])
    if not math.isfinite(loss):
        raise RuntimeError(f"bad loss {loss}")
    return loss


def _dryrun(n_devices: int) -> dict:
    from .config import QCPINNConfig
    from .data import gaussian_pulse_samplers
    from .models import DVSolver
    from .parallel import make_mesh
    from .physics.streams import dv_diffusion_residual_streams
    from .train import diffusion_terms

    amp = amp_for(n_devices)
    mesh = make_mesh(data=n_devices // amp, amp=amp, device="cpu")
    # the flagship shape: 12 qubits, cross_mesh, tangent-stream residuals on
    # the amp-sharded evolution, the configuration amp sharding exists for
    cfg = QCPINNConfig(num_qubits=12 if amp > 1 else 4, q_ansatz="cross_mesh",
                       classic_network=(3, 16, 1), batch_size=2 * n_devices, epochs=1,
                       lr=1e-3, seed=0)
    terms = diffusion_terms(gaussian_pulse_samplers(), cfg.batch_size)
    out = {"mesh": mesh.shape}
    model = DVSolver(cfg, device="cpu")
    residual_fn = None
    if amp > 1:
        model.use_sharded(mesh)
        residual_fn = lambda X: dv_diffusion_residual_streams(model, X)  # noqa: E731
    out["loss"] = _one_step(model, cfg, terms, mesh, residual_fn)
    if mesh.is_main:
        print(f"dryrun_multichip(n={n_devices}, mesh={mesh.shape}): "
              f"loss={out['loss']:.4e} OK", flush=True)
    if amp > 1:
        # the second road: the block engine over the sharded high block
        model_b = DVSolver(cfg, device="cpu").use_sharded(mesh, backend="block")
        out["loss_block"] = _one_step(
            model_b, cfg, terms, mesh, lambda X: dv_diffusion_residual_streams(model_b, X))
        if mesh.is_main:
            print(f"dryrun_multichip(n={n_devices}, backend=block): "
                  f"loss={out['loss_block']:.4e} OK", flush=True)
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """One full train step on an ``n_devices``-rank gloo world on the CPU
    (see the module docstring); returns rank 0's losses."""
    from . import graft_entry  # this module by name, also under ``python -m``
    from .parallel.mesh import run_cpu_world

    return run_cpu_world(n_devices, graft_entry._dryrun, n_devices)[0]


if __name__ == "__main__":
    dryrun_multichip(8)
    fn, args = entry(device="cpu")
    print("entry forward:", tuple(fn(*args).shape))
