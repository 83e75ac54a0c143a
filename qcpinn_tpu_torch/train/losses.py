"""Loss helpers (port of qcpinn_tpu/train/losses.py: ``mse`` and the
evaluation metric ``relative_l2``; the adaptive balancers are not yet
ported: ROADMAP queue 1, hardware-fidelity modes)."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def relative_l2(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """||pred - target||_2 / ||target||_2 — the reference's evaluation metric
    (trainer/diffusion_hybrid_trainer.py:176-184)."""
    num = torch.sqrt(torch.sum((pred - target) ** 2))
    den = torch.sqrt(torch.sum(target**2) + eps)
    return num / den
