"""Physical <-> normalized coordinate and field transforms with the
derivative chain rule (port of qcpinn_tpu/data/scaler.py;
si_q_pinn_improved.py:117-140, :387-406).

A model trained in normalized coordinates x_hat = (x - shift) / scale has
physical derivatives

  du/dx_phys = (du/dx_hat) / x_scale,   d2u/dx_phys2 = (d2u/dx_hat2) / x_scale^2

and predicted fields map back with their own (shift, scale). The fit runs on
the host in float64 numpy; the transforms act on tensors in their own dtype
and on their own device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Scaler:
    """Affine normalizer of a coordinate or field block ``[N, d]``."""

    shift: np.ndarray  # [d]
    scale: np.ndarray  # [d]

    @classmethod
    def fit(cls, values: np.ndarray, mode: str = "minmax") -> "Scaler":
        """mode='minmax' -> [0, 1]; 'maxabs' -> [-1, 1] around 0;
        'standard' -> zero mean, unit variance."""
        values = np.asarray(values, dtype=np.float64)
        if mode == "minmax":
            lo = values.min(axis=0)
            hi = values.max(axis=0)
            return cls(shift=lo, scale=np.maximum(hi - lo, 1e-12))
        if mode == "maxabs":
            m = np.maximum(np.abs(values).max(axis=0), 1e-12)
            return cls(shift=np.zeros_like(m), scale=m)
        if mode == "standard":
            return cls(shift=values.mean(axis=0),
                       scale=np.maximum(values.std(axis=0), 1e-12))
        raise ValueError(f"unknown mode {mode!r}")

    @staticmethod
    def _like(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self._like(self.shift, x)) / self._like(self.scale, x)

    def inverse(self, x_hat: torch.Tensor) -> torch.Tensor:
        return x_hat * self._like(self.scale, x_hat) + self._like(self.shift, x_hat)

    def d_dphys(self, grad_hat: torch.Tensor, col: Optional[int] = None) -> torch.Tensor:
        """First-derivative chain rule: du/dx_phys from du/dx_hat."""
        scale = self._like(self.scale, grad_hat)
        return grad_hat / (scale[col] if col is not None else scale)

    def d2_dphys2(self, hess_hat: torch.Tensor, col: Optional[int] = None) -> torch.Tensor:
        """Second-derivative chain rule: d2u/dx_phys^2 from d2u/dx_hat^2."""
        scale = self._like(self.scale, hess_hat)
        return hess_hat / ((scale[col] if col is not None else scale) ** 2)

    def to_dict(self) -> dict:
        return {"shift": self.shift.tolist(), "scale": self.scale.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "Scaler":
        return cls(shift=np.asarray(d["shift"], dtype=np.float64),
                   scale=np.asarray(d["scale"], dtype=np.float64))
