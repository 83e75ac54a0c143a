"""Composite losses, adaptive balancers and the evaluation metric (port of
qcpinn_tpu/train/losses.py).

- Fixed weighting: L = w_r L_res + w_bc L_bc + w_ic L_ic, default (2, 4, 2)
  (trainer/diffusion_train.py:47).
- EMAWeights: normalized-magnitude EMA balancer
  (CG_HQPINN_IBMtest_16qubits.py:408-423).
- Uncertainty (homoscedastic) balancer: sum exp(-s_k) L_k + s_k with
  learnable log-variances s_k (si_q_pinn_improved.py:143-164).

A balancer's state is a dict of scalar tensors, one per term;
``train/loop.py`` keeps it on the model.
"""

from __future__ import annotations

from typing import Dict

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def weighted_sum(losses: Dict[str, torch.Tensor], weights: Dict[str, float]):
    total = 0.0
    for k, v in losses.items():
        total = total + weights.get(k, 1.0) * v
    return total


def ema_weights_init(names, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.ones((), dtype=torch.float32, device=device) for k in names}


def ema_weights_update(
    state: Dict[str, torch.Tensor], losses: Dict[str, torch.Tensor], beta: float = 0.95
) -> Dict[str, torch.Tensor]:
    """EMA of each term's magnitude relative to the mean term magnitude
    (CG_HQPINN_IBMtest_16qubits.py:413-422). Call on detached losses."""
    avg = torch.clamp(sum(losses.values()) / max(len(losses), 1), min=1e-12)
    return {k: beta * state[k] + (1.0 - beta) * (v / avg) for k, v in losses.items()}


def uncertainty_init(names, device=None) -> Dict[str, torch.Tensor]:
    """Learnable log-variances, one per loss term (init 0)."""
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in names}


def uncertainty_combine(log_vars, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sum_k exp(-s_k) L_k + s_k (si_q_pinn_improved.py:143-164)."""
    total = 0.0
    for k, loss in losses.items():
        s = log_vars[k]
        total = total + torch.exp(-s) * loss + s
    return total


def relative_l2(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """||pred - target||_2 / ||target||_2 — the reference's evaluation metric
    (trainer/diffusion_hybrid_trainer.py:176-184)."""
    num = torch.sqrt(torch.sum((pred - target) ** 2))
    den = torch.sqrt(torch.sum(target**2) + eps)
    return num / den
