"""Clipping and Adam (port of the bench step's
``optax.chain(clip_by_global_norm(max_norm), adam(lr))``).

``clip_by_global_norm`` follows optax's formula exactly: the gradients are
rescaled by ``max_norm / norm`` only when ``norm >= max_norm``, with no
epsilon. ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is
not used. ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8) has the same
update as ``optax.adam``.
"""

from __future__ import annotations

from typing import Iterable

import torch


def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float):
    """Clip the ``.grad`` of ``params`` in place; returns the global norm.
    No host synchronisation: the branch is a ``torch.where``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
