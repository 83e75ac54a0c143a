"""Measurement (port of qcpinn_tpu/ops/measure.py, exact mode only).

``exact_z`` reads ``<Z_w>`` from the statevector; it is differentiable and
is the training path. Noise channels and shot sampling are not ported yet.
"""

from __future__ import annotations

import torch

from . import statevector as sv


def exact_z(state: torch.Tensor, n: int, noise=None) -> torch.Tensor:
    if noise is not None:
        raise NotImplementedError("noise models are not yet ported")
    return sv.z_expvals(state, n)
