"""The Czochralski pretrain step of the port (``train/cz_pipeline.py``
``PretrainEpoch``) as the window drives it: each batch of melt nodes copied
into the step's static buffers the way ``PretrainEpoch.__call__`` does (a
seeded permutation of all nodes, drawn anew every epoch), then one call of
the captured step. The physics weight and the cosine learning rate are
those of the traffic's epoch."""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch

from lib import flops
from lib.spec import ROOT, reference
from qcpinn_tpu_torch.data.cz_loader import load_cz_data
from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
from qcpinn_tpu_torch.train import cz_pipeline as czp
from qcpinn_tpu_torch.train import optim as port_optim

B1 = 0.9


def draw_weights(model, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from ``seed`` on the device, in two draws: Xavier-normal
    weights (std sqrt(2 / (in + out))) and the Fourier matrix (N(0, 1) times
    its scale) from one normal draw, the circuit weights U(0, 2 pi) from one
    uniform draw; zero biases, LayerNorm 1 and 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    normal = [k for k in shapes if k.endswith(".weight") or k == "B"]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in normal), generator=gen, device=device)
    q = 2 * math.pi * torch.rand(shapes["q"], generator=gen, device=device)
    out, at = {}, 0
    for k in normal:
        size = math.prod(shapes[k])
        std = (cfg["fourier_scale"] if k == "B"
               else math.sqrt(2.0 / (shapes[k][0] + shapes[k][1])))
        out[k] = std * flat[at:at + size].reshape(shapes[k])
        at += size
    for k, shape in shapes.items():
        if k == "q":
            out[k] = q
        elif k not in out:
            fill = 1.0 if k.endswith("gamma") else 0.0
            out[k] = torch.full(shape, fill, device=device)
    return out


def model_widths(model) -> Dict[str, Tuple[int, ...]]:
    """Each MLP of the built model as (in, ..., out), read from its weights
    (``name.i.weight`` is ``[out, in]``)."""
    layers: Dict[str, list] = {}
    for k, v in model.state_dict().items():
        parts = k.split(".")
        if len(parts) == 3 and parts[2] == "weight" and v.ndim == 2:
            layers.setdefault(parts[0], []).append((int(parts[1]), tuple(v.shape)))
    return {name: (ws[0][1][1],) + tuple(shape[0] for _, shape in ws)
            for name, ws in ((n, sorted(w)) for n, w in layers.items())}


def check_widths(model, cfg: dict) -> None:
    """The configuration's widths are the model's: the MLPs, the residual
    blocks and the Fourier features, or the run stops."""
    stated = reference(cfg["name"]).mlp_dims(cfg)
    built = model_widths(model)
    features = model.state_dict()["B"].shape[-1]
    if built != stated or features != cfg["fourier_features"]:
        raise SystemExit(f"the configuration's widths {stated} and {cfg['fourier_features']} "
                         f"Fourier features are not the model's: {built} and {features}")


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.data_path = os.path.join(ROOT, cfg["data"])
        X, Y, stats = load_cz_data(self.data_path)
        b = traffic["batch"]
        self.ccfg = czp.CzConfig(
            n_qubits=cfg["n_qubits"], n_layers=cfg["n_layers"], epochs=cfg["epochs"],
            batch_size=b, lr=cfg["lr"], re=cfg["re"], pr=cfg["pr"], gr=cfg["gr"],
            physics_weight=cfg["physics_weight"], physics_warmup=cfg["physics_warmup"],
            physics_ramp=cfg["physics_ramp"], ema_beta=cfg["ema_beta"],
            physics_mode=cfg["physics_mode"], physics_normalize=cfg["physics_normalize"])
        model = Hybrid16QPINN(cfg["n_qubits"], cfg["n_layers"], remat=self.ccfg.effective_remat,
                              width=cfg["trunk_width"], device=device)
        check_widths(model, cfg)
        self.weights = draw_weights(model, cfg, seed, device)
        model.load_state_dict(self.weights)
        self.names = [k for k, p in model.named_parameters() if p.requires_grad]
        self.pe = czp.make_pretrain_epoch(model, X, Y, stats, self.ccfg)
        e = float(traffic["epoch"])
        self.pe.phys_w.fill_(czp._phys_weight(self.ccfg, e))
        self.pe.lr.fill_(czp._cosine_lr(self.ccfg.lr, e, self.ccfg.epochs))
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.batch = b
        self.per_epoch = self.pe.n_batches
        self.taken = 0
        self.points_per_step = b

    def _feed(self) -> torch.Tensor:
        """The next batch into the step's buffers, as ``__call__`` feeds
        them; a new permutation of all nodes every epoch. Returns the
        batch's row indices."""
        pe, i = self.pe, self.taken % self.per_epoch
        if i == 0:
            nb, b = self.per_epoch, self.batch
            self._perm = torch.randperm(len(pe.Xd), generator=self.gen,
                                        device=self.device)[: nb * b].reshape(nb, b)
            self._xs, self._ys = pe.Xd[self._perm], pe.Yd[self._perm]
        pe.xb.copy_(self._xs[i])
        pe.yb.copy_(self._ys[i])
        self.taken += 1
        return self._perm[i]

    def _run(self) -> torch.Tensor:
        return (self.pe._step or self.pe.static_step)()

    def step(self) -> torch.Tensor:
        """One step of the window; returns its loss (a device scalar)."""
        self._feed()
        return self._run()[0]

    def eager_step(self) -> None:
        """The step's plain version (what the graph captured), eagerly."""
        self._feed()
        self.pe.static_step()

    def compared_steps(self) -> dict:
        """The first steps through the window's own call and feed, with
        the readings that the reference is held to: each step's loss, the
        first step's gradient as Adam took it (its first moment over 1 -
        beta1) and each parameter's change over the steps."""
        losses, self.batches = [], []
        for k in range(self.traffic["compared_steps"]):
            self.batches.append(self._feed().cpu().numpy())
            losses.append(float(self._run()[0]))
            if k == 0:
                grad1 = {n: float(torch.linalg.vector_norm(m.double())) / (1.0 - B1)
                         for n, m in zip(self.names, self.pe.opt_state.mu)}
        params = dict(self.pe.model.named_parameters())
        change = {n: float(torch.linalg.vector_norm((params[n].detach()
                                                     - self.weights[n]).double()))
                  for n in self.names}
        return {"losses": losses, "grad1": grad1, "change": change}

    def work(self) -> dict:
        """Model operations a step at the gate level: the five residual
        coefficients (u, u_r, u_z, u_rr, u_zz) of every point and one data
        row a point, each a forward through the circuit and the MLPs, the
        backward twice the forward."""
        ref = reference(self.cfg["name"])
        n = self.cfg["n_qubits"]
        per_row = (flops.circuit_flops(ref.circuit_gates(n, self.cfg["n_layers"]), n)
                   + flops.readout_flops(n)
                   + sum(flops.mlp_flops(d) for d in ref.mlp_dims(self.cfg).values()))
        rows = 6 * self.batch
        return {"model_flops": 3 * rows * per_row}

    def free(self) -> None:
        del self.pe

    def reference(self, device) -> dict:
        ref = reference(self.cfg["name"])
        return ref.follow(self.cfg, self.traffic, self.weights, self.batches, self.data_path,
                          device)

    # -- faults the comparison has to catch (tests and calibrate.py) ----------

    def plant(self, fault: str):
        """Break the timed path underneath; returns the call that mends it."""
        pe = self.pe
        if fault == "unchanged":  # the step leaves the parameters as they were
            inner = port_optim.apply_updates
            port_optim.apply_updates = lambda params, updates: None

            def mend():
                port_optim.apply_updates = inner
        elif fault == "half_batch":  # half the rows left out, the mean over the rest
            def half(xb, yb, phys_w):
                h = xb.shape[0] // 2
                return type(pe).batch_loss(pe, xb[:h], yb[:h], phys_w)

            pe.batch_loss = half

            def mend():
                del pe.batch_loss
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return mend


def build(cfg: dict, traffic: dict, seed: int, device) -> System:
    return System(cfg, traffic, seed, device)
