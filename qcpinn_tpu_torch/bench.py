"""Headline benchmark of the port: collocation points/sec for a full
training step of the 12-qubit cross_mesh DVFourierSolver on
convection-diffusion (twin of the root ``bench.py``), on the card.

One step: sample 1024 residual points and 341 + 341 boundary / initial
points -> tangent-stream residuals (the primal state plus five derivative
streams as one 6 x 1024-row evolve) -> value terms through the model (682
rows) -> 2/4/2 loss -> backward -> clip_by_global_norm(1.0) -> Adam(5e-3).
At 12 qubits the evolution runs in the CUDA block-chain kernels
(ops/block_kernel.py), at 7-9 qubits in the unrolled micro-program kernels
(ops/sv_kernel.py), once forward and once backward per batch.

    python -m qcpinn_tpu_torch.bench [--qubits 8] [--batch 256]
                                     [--backend block] [--profile]

``--qubits`` and ``--batch`` are the root script's circuit width and
``QCPINN_BENCH_BATCH`` (and ``scripts/chip_16q_train.py <B> <n>``); the
value terms take ``batch // 3`` points each.

runs a warm-up of 30 steps, then times 3 x 30 steps as one window, and
prints one JSON line: metric, value (points/sec over the whole window:
all the steps over all the time), unit, the card's name
and power limit, and the engine. ``--backend`` picks another engine for an
A/B on the same card; ``--profile`` adds a line with the device time per
step by kernel (torch.profiler). On the card the step is captured in a CUDA
graph and replayed (``train/loop.py``'s ``CapturedStep``); the eager step
is its plain version (``Trainer(eager=True)``, and the CPU).
"""

from __future__ import annotations

import json
import subprocess
import time
import torch

from . import resolve_device
from .config import QCPINNConfig
from .data import diffusion as dd
from .models.dv_fourier import DVFourierSolver
from .physics.streams import dv_diffusion_residual_streams
from .train.loop import CapturedStep
from .train.optim import adam, clip_by_global_norm


def metric(n_qubits: int) -> str:
    return f"collocation points/sec, {n_qubits}-qubit cross_mesh QCPINN train step"


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit": limit, "nvidia_smi": out}


def bench_loss(model, Xr, yr, Xb, yb, Xi, yi) -> torch.Tensor:
    """The bench step's 2/4/2 loss: streams residual plus one model call
    for both value terms."""
    _, r = dv_diffusion_residual_streams(model, Xr)
    pv = model(torch.cat([Xb, Xi], dim=0))
    nb = Xb.shape[0]
    return (
        2.0 * torch.mean((r - yr) ** 2)
        + 4.0 * torch.mean((pv[:nb] - yb) ** 2)
        + 2.0 * torch.mean((pv[nb:] - yi) ** 2)
    )


class Trainer:
    """The bench train step: samplers, model, clip + Adam. On the card the
    step runs as a captured CUDA graph unless ``eager``; Adam keeps its step
    count on the card either way, so both run the same arithmetic."""

    def __init__(self, model: DVFourierSolver, batch: int, lr: float, seed: int,
                 eager: bool = False):
        self.model = model
        self.batch = batch
        self.third = max(batch // 3, 1)
        on_card = model.device.type == "cuda"
        self.opt = adam(model.parameters(), lr, capturable=on_card)
        self.gen = torch.Generator(device=model.device).manual_seed(seed + 1)
        self.graph = None if eager or not on_card else CapturedStep(
            self.eager_step, self.gen)
        box = dd._box
        self.res_s = dd.Sampler(box([[0, 0, 0], [1, 1, 1]]), dd.r_true)
        self.bc_s = dd.Sampler(box([[0, 0, 0], [1, 0, 1]]), dd.u)
        self.ic_s = dd.Sampler(box([[0, 0, 0], [0, 1, 1]]), dd.u)

    def sample(self):
        Xr, yr = self.res_s.sample(self.gen, self.batch)
        Xb, yb = self.bc_s.sample(self.gen, self.third)
        Xi, yi = self.ic_s.sample(self.gen, self.third)
        return Xr, yr, Xb, yb, Xi, yi

    def eager_step(self) -> torch.Tensor:
        """One train step, eagerly; returns the loss (no host
        synchronisation). The parameters, the gradients and Adam's state are
        updated in place, so the graph captures this step as it is."""
        loss = bench_loss(self.model, *self.sample())
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(self.model.parameters(), 1.0)
        self.opt.step()
        return loss.detach()

    def step(self) -> torch.Tensor:
        """One train step (a graph replay on the card); returns the loss."""
        if self.graph is None:
            return self.eager_step()
        return self.graph().clone()


def build(
    batch: int = 1024,
    n_qubits: int = 12,
    hidden: int = 50,
    backend: str = "auto",
    seed: int = 42,
    lr: float = 5e-3,
    device=None,
    eager: bool = False,
) -> Trainer:
    """The bench configuration on ``device`` (default: the card; raises
    without CUDA). ``eager`` runs the plain eager step on the card."""
    device = resolve_device(device)
    cfg = QCPINNConfig(
        num_qubits=n_qubits,
        num_quantum_layers=1,
        q_ansatz="cross_mesh",
        classic_network=(3, hidden, 1),
        batch_size=batch,
        lr=lr,
        seed=seed,
    )
    model = DVFourierSolver(cfg, device=device)
    model.use_fused(backend)
    return Trainer(model, batch, lr, seed, eager=eager)


def run(trainer: Trainer, steps: int = 30, trials: int = 3) -> float:
    """A warm-up of ``steps`` steps, then ``trials * steps`` timed steps in
    one window; returns the window's seconds per step, so a stall anywhere
    in it counts."""
    for _ in range(steps):
        trainer.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(trials * steps):
        loss = trainer.step()
    float(loss)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (trials * steps)


def profile(trainer, ms_per_step: float, steps: int = 5, top: int = 12) -> dict:
    """Device time per step by kernel name (torch.profiler over ``steps``
    calls of ``trainer.step()``; it sees the kernels inside a graph's
    replay) beside ``ms_per_step``, the step's time measured without the
    profiler (whose own overhead stretches the profiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(steps):
            trainer.step()
        torch.cuda.synchronize()
    by_name: dict = {}
    launches = 0
    for e in p.events():
        if e.device_type == DeviceType.CUDA:  # one kernel (or copy) on the card
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    rows = sorted(((k, us / 1e3 / steps) for k, us in by_name.items()),
                  key=lambda r: -r[1])
    device = sum(ms for _, ms in rows)
    return {
        "ms_per_step": ms_per_step,
        "device_ms_per_step": device,
        "device_launches_per_step": launches / steps,
        "top_device_ms_per_step": rows[:top],
    }


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qubits", type=int, default=12)
    ap.add_argument("--batch", type=int, default=1024,
                    help="residual points per step")
    ap.add_argument("--backend", default="auto",
                    help="evolution engine (ops/backends.py); default auto")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time per step by kernel")
    args = ap.parse_args()
    trainer = build(batch=args.batch, n_qubits=args.qubits, backend=args.backend)
    dt = run(trainer)
    info = card()
    print(json.dumps({
        "metric": metric(args.qubits),
        "value": trainer.batch / dt,
        "unit": "points/sec",
        "name": info["name"],
        "power_limit": info["power_limit"],
        "backend": type(trainer.model.qblock).__name__,
    }))
    if args.profile:
        print(json.dumps({"profile": profile(trainer, 1e3 * dt),
                          "card": info["nvidia_smi"]}))


if __name__ == "__main__":
    main()
