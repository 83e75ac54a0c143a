"""Plots, off the hot path (port of the functions of
qcpinn_tpu/utils/plotting.py that ``cli train`` and ``cli cz`` draw; the
reference's utils/ContourPlotter.py, loss plots and the Czochralski
diagnostics suite): the training curve, the per-timestep contour grid with
shared per-row color scales, the (r, z) field scatter and the pre-finetune
diagnostics. matplotlib is imported when a plot is drawn, never with the
module."""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

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


def plot_field_scatter(
    coords: np.ndarray,
    values: np.ndarray,
    names: Sequence[str],
    out_dir: str,
    name: str = "fields",
    pred: Optional[np.ndarray] = None,
) -> str:
    """Scatter plots of (r, z) fields (the Czochralski diagnostics suite,
    cg-hqpinn/...:515-587): the ground-truth fields and, with ``pred``, the
    prediction below each."""
    plt = _mpl()
    k = values.shape[1]
    nrows = 2 if pred is not None else 1
    fig, axes = plt.subplots(nrows, k, figsize=(3.2 * k, 3.2 * nrows), squeeze=False)
    for i in range(k):
        im = axes[0][i].scatter(coords[:, 0], coords[:, 1], c=values[:, i], s=2,
                                cmap="rainbow")
        axes[0][i].set_title(names[i])
        fig.colorbar(im, ax=axes[0][i])
        if pred is not None:
            im = axes[1][i].scatter(coords[:, 0], coords[:, 1], c=pred[:, i], s=2,
                                    cmap="rainbow")
            axes[1][i].set_title(f"pred {names[i]}")
            fig.colorbar(im, ax=axes[1][i])
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return path


@torch.no_grad()
def plot_cz_diagnostics(
    model,
    X: np.ndarray,
    Y: np.ndarray,
    out_dir: str,
    x_calib: Optional[np.ndarray] = None,
    q_key: str = "q",
    max_points: int = 2000,
    device=None,
) -> list:
    """The reference's pre-finetune diagnostic suite
    (cg-hqpinn/CG_HQPINN_IBMtest_16q_effective.py:515-587): data_fields.png
    ((r, z) colored per field), calib_coverage.png (the calibration picks
    over the node cloud), initial_pred_vs_gt.png (prediction against truth
    per field, with y = x), quantum_weights_hist.png, and weight_audit.txt
    (per block mean, std, max |w| and the share of dead weights, and the
    quantum weights' span). ``model`` runs on ``device`` (default: the
    card); its weights are read in the JAX tree's layout."""
    from ..bridge import params_to_jax
    from .checkpoint import flatten

    device = resolve_device(device)
    plt = _mpl()
    names = ["u_r", "u_z", "u_theta", "p", "T"]
    X = np.asarray(X)
    Y = np.asarray(Y)
    params = params_to_jax(model)
    paths = []

    fig, axes = plt.subplots(1, 5, figsize=(22, 4))
    for i, (ax, nm) in enumerate(zip(axes, names)):
        sc = ax.scatter(X[:, 0], X[:, 1], c=Y[:, i], s=1, cmap="viridis")
        ax.set_xlabel("r"); ax.set_ylabel("z"); ax.set_title(nm)
        fig.colorbar(sc, ax=ax)
    fig.suptitle("Training data fields (normalised)")
    fig.tight_layout()
    p = os.path.join(out_dir, "data_fields.png")
    fig.savefig(p, dpi=150); plt.close(fig); paths.append(p)

    if x_calib is not None:
        xc = np.asarray(x_calib)
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.scatter(X[:, 0], X[:, 1], s=1, alpha=0.3, label="full data")
        ax.scatter(xc[:, 0], xc[:, 1], s=30, c="red", marker="x", label=f"calib ({len(xc)})")
        ax.set_xlabel("r"); ax.set_ylabel("z")
        ax.set_title("Calibration subset coverage")
        ax.legend(); fig.tight_layout()
        p = os.path.join(out_dir, "calib_coverage.png")
        fig.savefig(p, dpi=150); plt.close(fig); paths.append(p)

    rng = np.random.default_rng(0)
    idx = rng.choice(len(X), min(max_points, len(X)), replace=False)
    pred = model(torch.as_tensor(np.asarray(X[idx], np.float32), device=device)).cpu().numpy()
    gt = Y[idx]
    fig, axes = plt.subplots(1, 5, figsize=(22, 4))
    for i, (ax, nm) in enumerate(zip(axes, names)):
        lo = min(gt[:, i].min(), pred[:, i].min())
        hi = max(gt[:, i].max(), pred[:, i].max())
        ax.scatter(gt[:, i], pred[:, i], s=2, alpha=0.4)
        ax.plot([lo, hi], [lo, hi], "r--", lw=1)
        ax.set_xlabel("ground truth"); ax.set_ylabel("prediction")
        ax.set_title(nm)
    fig.suptitle("Predictions vs ground truth")
    fig.tight_layout()
    p = os.path.join(out_dir, "initial_pred_vs_gt.png")
    fig.savefig(p, dpi=150); plt.close(fig); paths.append(p)

    if q_key in params:
        qw = np.asarray(params[q_key]).ravel()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(qw, bins=50, edgecolor="black", alpha=0.7)
        ax.set_xlabel("weight value"); ax.set_ylabel("count")
        ax.set_title("Quantum layer weight distribution")
        fig.tight_layout()
        p = os.path.join(out_dir, "quantum_weights_hist.png")
        fig.savefig(p, dpi=150); plt.close(fig); paths.append(p)

    # the text weight audit (cg-hqpinn/diagnostics/readme.md:1-15)
    lines = ["block                    mean        std      |w|max   frac|w|<1e-6"]
    for k in sorted(params.keys()):
        leaves = [np.asarray(a).ravel() for a in flatten(params[k])]
        if not leaves:
            continue
        w = np.concatenate(leaves)
        lines.append(f"{k:<20} {w.mean():+10.4f} {w.std():10.4f} "
                     f"{np.abs(w).max():10.4f} {np.mean(np.abs(w) < 1e-6):10.4f}")
    if q_key in params:
        qw = np.asarray(params[q_key]).ravel()
        lines.append(f"quantum span [{qw.min():.3f}, {qw.max():.3f}] rad "
                     f"(wrap-around expected once trained: ~[0, 2pi])")
    p = os.path.join(out_dir, "weight_audit.txt")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    paths.append(p)
    return paths
