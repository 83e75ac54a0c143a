"""Plots, off the hot path (port of the two functions of
qcpinn_tpu/utils/plotting.py that ``cli train`` draws; the reference's
utils/ContourPlotter.py and loss plots): the training curve and the
per-timestep contour grid with shared per-row color scales. matplotlib is
imported when a plot is drawn, never with the module."""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from .. import resolve_device


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss_history(loss_history: Sequence[float], out_dir: str, name: str = "loss_history") -> str:
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(np.asarray(loss_history))
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.grid(True, alpha=0.3)
    path = os.path.join(out_dir, f"{name}.pdf")
    fig.savefig(path, bbox_inches="tight", dpi=300)
    fig.savefig(os.path.join(out_dir, f"{name}.png"), bbox_inches="tight", dpi=150)
    plt.close(fig)
    return path


@torch.no_grad()
def draw_contourf_grid(
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    analytic_u: Callable,
    out_dir: str,
    times: Sequence[float] = (0.25, 0.5, 0.75),
    num: int = 50,
    name: str = "contour_plots",
    per_timestep: bool = False,
    device=None,
) -> str:
    """3-row grid per timestep: prediction / exact / |error|, shared row
    scales (ContourPlotter.draw_contourf_regular_2D semantics), the model
    run on ``device`` (default: the card). ``per_timestep`` also exports
    one 300-dpi ``tricontourf_{i}.pdf`` per time step
    (ContourPlotter.py:34-45 filename convention)."""
    device = resolve_device(device)
    plt = _mpl()
    g = np.linspace(0.0, 1.0, num, dtype=np.float32)
    X, Y = np.meshgrid(g, g, indexing="ij")

    fig, axes = plt.subplots(
        3, len(times), figsize=(4 * len(times), 10), squeeze=False
    )
    rows = {0: [], 1: [], 2: []}
    fields = []
    for t in times:
        pts = torch.as_tensor(
            np.stack([np.full(X.size, t, np.float32), X.ravel(), Y.ravel()], 1),
            device=device)
        pred = model_apply(pts).cpu().numpy().reshape(num, num)
        exact = analytic_u(pts).cpu().numpy().reshape(num, num)
        err = np.abs(pred - exact)
        fields.append((pred, exact, err))
        for r, f in enumerate((pred, exact, err)):
            rows[r].append(f)

    for r in range(3):
        vmin = min(f.min() for f in rows[r])
        vmax = max(f.max() for f in rows[r])
        for c, t in enumerate(times):
            cmap = "rainbow" if r < 2 else "Oranges"
            im = axes[r][c].contourf(
                X, Y, fields[c][r], levels=50, cmap=cmap, vmin=vmin, vmax=vmax
            )
            label = ["prediction", "exact", "|error|"][r]
            axes[r][c].set_title(f"{label} @ t={t}")
            fig.colorbar(im, ax=axes[r][c])

    path = os.path.join(out_dir, f"{name}.pdf")
    fig.savefig(path, bbox_inches="tight", dpi=300)
    fig.savefig(os.path.join(out_dir, f"{name}.png"), bbox_inches="tight", dpi=150)
    plt.close(fig)

    if per_timestep:
        # one 300-dpi PDF per time step (ContourPlotter.py:34-45,:153-173):
        # row-shared solution scale, error floored at 0
        for i, t in enumerate(times):
            pred, exact, err = fields[i]
            smin = min(pred.min(), exact.min())
            smax = max(pred.max(), exact.max())
            if smax <= smin:  # constant slice: widen so levels increase
                smax = float(smin) + max(1e-6, abs(float(smin)) * 1e-5)
            f1, ax1 = plt.subplots(1, 3, figsize=(12, 3.6))
            panels = [
                (pred, "prediction", "rainbow", smin, smax),
                (exact, "exact", "rainbow", smin, smax),
                (err, "|error|", "Oranges", 0.0, max(float(err.max()), 1e-6)),
            ]
            for a, (f, ttl, cmap, vmin, vmax) in zip(ax1, panels):
                im = a.contourf(
                    X, Y, f, levels=np.linspace(vmin, vmax, 50), cmap=cmap,
                    vmin=vmin, vmax=vmax,
                )
                a.set_aspect("equal", adjustable="box")
                a.set_title(f"{ttl} @ t={t}")
                f1.colorbar(im, ax=a, format="%.1e")
            f1.savefig(
                os.path.join(out_dir, f"tricontourf_{i}.pdf"),
                dpi=300, bbox_inches="tight", facecolor="white",
            )
            plt.close(f1)
    return path
