"""Unified experiment configuration.

Replaces the reference's four coexisting config styles (plain args dict,
argparse, class-attribute Config, module constants — SURVEY.md §5.6) with one
dataclass. Field names track the reference args keys
(trainer/diffusion_hybrid_trainer.py:44-74) so configs translate 1:1.

The PyTorch port keeps this copy of ``qcpinn_tpu/config.py`` because it
imports nothing of the JAX package; the two must stay field-for-field equal.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple


@dataclasses.dataclass
class QCPINNConfig:
    # problem / model selection
    problem: str = "diffusion"  # diffusion | wave | klein_gordon | helmholtz | navier_stokes
    solver: str = "DV"  # DV | CV | Classical
    classic_network: Tuple[int, int, int] = (3, 50, 1)  # [in, hidden, out]

    # DV quantum block
    num_qubits: int = 4
    num_quantum_layers: int = 1
    q_ansatz: str = "cascade"
    encoding: str = "angle"  # angle | angle_pi | amplitude

    # CV quantum block
    cv_class: int = 1  # CVNeuralNetwork variant 1 | 2 | 3
    cutoff_dim: int = 6
    # None = the reference's per-variant readout ('x' for v2, '<n>'
    # otherwise); 'x'|'n' overrides it (round-5 CV diagnosis: the
    # ⟨n⟩-at-vacuum readout is the v1/v3 trainability stall)
    cv_readout: Optional[str] = None

    # training
    epochs: int = 20000
    batch_size: int = 64
    lr: float = 5e-3
    seed: int = 42
    print_every: int = 500
    grad_clip: Optional[float] = None  # default: 0.1 for CV else 1.0
    weight_decay: Optional[float] = None  # default: 0.001 for CV else 0.0
    loss_weights: Tuple[float, float, float] = (2.0, 4.0, 2.0)  # (res, bc, ic)
    scheduler: str = "plateau"  # plateau | cosine | none
    plateau_factor: float = 0.9
    plateau_patience: Optional[int] = None  # default: 800 for CV else 1000

    # hardware-fidelity modes (replaces use_ibm_hardware and friends —
    # no cloud dependency; shots/noise are engine modes)
    shots: Optional[int] = None
    noise_depolarizing: float = 0.0
    noise_readout: float = 0.0
    # depth-aware per-gate depolarizing rate (ops/measure.py NoiseModel)
    noise_per_gate: float = 0.0
    gradient_mode: str = "backprop"  # backprop | parameter-shift | spsa | spsa-split
    # adaptive loss balancing (train/losses.py): none | ema | uncertainty
    loss_balancer: str = "none"

    # bookkeeping
    run_name: Optional[str] = None
    output_dir: str = "runs"

    def __post_init__(self):
        self.classic_network = tuple(self.classic_network)
        self.loss_weights = tuple(self.loss_weights)
        if self.solver not in ("DV", "CV", "Classical"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.encoding not in ("angle", "angle_pi", "amplitude"):
            raise ValueError(f"unknown encoding {self.encoding!r}")
        if self.gradient_mode not in (
            "backprop", "parameter-shift", "spsa", "spsa-split"
        ):
            raise ValueError(f"unknown gradient_mode {self.gradient_mode!r}")
        if self.loss_balancer not in ("none", "ema", "uncertainty"):
            raise ValueError(f"unknown loss_balancer {self.loss_balancer!r}")

    @property
    def effective_grad_clip(self) -> float:
        if self.grad_clip is not None:
            return self.grad_clip
        # trainer/diffusion_train.py:82-85: 0.1 for CV, 1.0 otherwise
        return 0.1 if self.solver == "CV" else 1.0

    @property
    def effective_weight_decay(self) -> float:
        if self.weight_decay is not None:
            return self.weight_decay
        # nn/CVPDESolver.py:65-78: Adam(weight_decay=0.001) for the CV
        # solver classes; plain Adam everywhere else.
        return 0.001 if self.solver == "CV" else 0.0

    @property
    def effective_plateau_patience(self) -> int:
        if self.plateau_patience is not None:
            return self.plateau_patience
        # nn/CVPDESolver.py:75-77 (patience=800) vs nn/DVPDESolver.py:61-64
        # (patience=1000).
        return 800 if self.solver == "CV" else 1000

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "QCPINNConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def masked_dict(self) -> dict:
        """Config dump with credential-looking keys masked
        (train_hybrid_qpinn.py:911-917 token masking)."""
        out = {}
        for k, v in self.to_dict().items():
            if isinstance(v, str) and ("token" in k.lower() or "secret" in k.lower()):
                v = "***masked***"
            out[k] = v
        return out
