"""Evaluation on a regular grid (port of
qcpinn_tpu/utils/evaluation.py: ``meshgrid_points`` and
``evaluate_relative_l2``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..train.losses import relative_l2


def meshgrid_points(num: int = 20, dims: int = 3, lo=None, hi=None) -> np.ndarray:
    """Regular grid over [lo, hi] (default unit hypercube), [num^dims, dims]
    float32 (the reference's 20^3 evaluation grid)."""
    lo = np.zeros(dims, np.float32) if lo is None else np.asarray(lo, np.float32)
    hi = np.ones(dims, np.float32) if hi is None else np.asarray(hi, np.float32)
    axes = [np.linspace(lo[d], hi[d], num, dtype=np.float32) for d in range(dims)]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


@torch.no_grad()
def evaluate_relative_l2(
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    analytic_u: Callable,
    analytic_r: Optional[Callable] = None,
    operator: Optional[Callable] = None,
    num: int = 20,
    batch: int = 4096,
    lo=None,
    hi=None,
    dims: int = 3,
    device=None,
) -> Dict[str, float]:
    """Relative L2 (%) of u, and with ``analytic_r`` and ``operator`` of the
    PDE residual against the analytic forcing, on a num^dims grid, in
    chunks of ``batch`` points on ``device`` (default: the card).
    ``operator(model_apply, X) -> (u, residual)``."""
    device = resolve_device(device)
    pts = torch.as_tensor(meshgrid_points(num, dims=dims, lo=lo, hi=hi), device=device)
    pred = torch.cat([model_apply(pts[i : i + batch])
                      for i in range(0, len(pts), batch)])
    out = {"rel_l2_u_percent": 100.0 * float(relative_l2(pred, analytic_u(pts)))}
    if analytic_r is not None and operator is not None:
        res = torch.cat([operator(model_apply, pts[i : i + batch])[1]
                         for i in range(0, len(pts), batch)])
        out["rel_l2_r_percent"] = 100.0 * float(relative_l2(res, analytic_r(pts)))
    return out
