"""The comparison that decides ``correct``: the program's readings over its
first steps against the plain reference's over the same inputs and
weights.

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: of the first step's gradient as Adam took it (after the
  clip), the largest gap between the program's and the reference's norm
  of a leaf, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``update_gap``: the same of each leaf's change over all the compared
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

NAMES = ("loss_gap", "grad_gap", "update_gap")
QUIET = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    g_med = float(np.median(list(ref["grad1"].values())))
    moving = [k for k, g in ref["grad1"].items() if g >= QUIET * g_med]
    return {
        "loss_gap": max(losses),
        "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"], list(ref["grad1"])),
        "update_gap": _leaf_gap(prog["change"], ref["change"], moving),
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number finite and within its limit."""
    return all(np.isfinite(values[k]) and values[k] <= limits[k] for k in limits)
