"""Evaluation (port of qcpinn_tpu/utils/evaluation.py): on a regular grid
(``meshgrid_points``, ``evaluate_relative_l2``) and on the Czochralski node
set (``evaluate_cz_fields``)."""

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


CZ_FIELDS = ("u_r", "u_z", "u_theta", "p", "T")


@torch.no_grad()
def evaluate_cz_fields(
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    X,
    Y,
    batch: int = 2048,
    return_pred: bool = False,
    mesh=None,
    device=None,
):
    """Field-wise relative L2 (%) and the overall val MSE on the
    (normalized) COMSOL node set, the flagship's accuracy metric. The model
    runs on ``device`` (default: the card) in chunks of ``batch`` rows, the
    last one padded to the same shape (at 16 qubits one forward over all
    18k nodes would hold an [N, 2^16] state); the metrics are computed on
    the host in numpy as JAX computes them. ``mesh`` (the data-parallel
    evaluation) is not yet ported."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel evaluation is not yet ported (ROADMAP queue 1, parallel)")
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y)
    n = len(X)
    preds = []
    for i in range(0, n, batch):
        c = X[i : i + batch]
        if len(c) < batch:
            c = np.pad(c, ((0, batch - len(c)), (0, 0)))
        preds.append(model_apply(torch.as_tensor(c, device=device)))
    pred = torch.cat(preds).cpu().numpy()[:n]
    out = {"val_mse": float(np.mean((pred - Y) ** 2))}
    for k, name in enumerate(CZ_FIELDS):
        num = float(np.linalg.norm(pred[:, k] - Y[:, k]))
        den = max(float(np.linalg.norm(Y[:, k])), 1e-12)
        out[f"rel_l2_{name}_percent"] = 100.0 * num / den
    if return_pred:
        return out, pred
    return out
