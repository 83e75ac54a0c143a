"""Clipping, Adam and schedules (port of qcpinn_tpu/train/optim.py and of
the optax transformations it chains).

``clip_by_global_norm`` follows optax's formula exactly: the gradients are
rescaled by ``max_norm / norm`` only when ``norm >= max_norm``, with no
epsilon. ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is
not used. ``adam`` (``torch.optim.Adam``, betas 0.9/0.999, eps 1e-8) has
the same update as ``optax.adam`` and drives the bench step.

:func:`make_optimizer` is the twin of the JAX ``make_optimizer``: an
optax-style transformation (``init`` / ``update``) of clip and Adam with a
constant or cosine learning rate, written out in torch so the update is
explicit and the plateau scale multiplies it as ``optim.scale_updates``
does in JAX. Its step count lives on the device, the learning rate and the
bias corrections are computed there in f32 (as optax does), and the
moments and the count update in place, so a step can be captured in a CUDA
graph (``train/loop.py``). The plateau state lives on the device and
updates with ``torch.where``: no host round trip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence

import torch


def _clip_factors(grads: List[torch.Tensor], max_norm: float):
    """(divisor, factor, global norm) of optax's clip: ``g / norm *
    max_norm`` where the norm reaches ``max_norm``, else 1 and 1 (``g``
    exactly). No host synchronisation: the branch is a ``torch.where``."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    return torch.where(keep, one, norm), torch.where(keep, one, one * max_norm), norm


def clip_grads(grads: Sequence[torch.Tensor], max_norm: float):
    """(clipped grads, global norm), optax's formula, on multi-tensor ops
    (a few launches for all the leaves)."""
    grads = list(grads)
    div, factor, norm = _clip_factors(grads, max_norm)
    clipped = torch._foreach_div(grads, div)
    torch._foreach_mul_(clipped, factor)
    return clipped, norm


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float):
    """Clip the ``.grad`` of ``params`` in place; returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    div, factor, norm = _clip_factors(grads, max_norm)
    torch._foreach_div_(grads, div)
    torch._foreach_mul_(grads, factor)
    return norm


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's and torch.optim.Adam's defaults


def adam(params, lr: float, capturable: bool = False) -> torch.optim.Adam:
    """``capturable`` keeps Adam's step count on the card, so that its step
    can be captured in a CUDA graph."""
    return torch.optim.Adam(params, lr=lr, betas=(B1, B2), eps=EPS,
                            capturable=capturable)


# -- the optax-style chain -------------------------------------------------------


def cosine_decay_schedule(lr: float, decay_steps: int) -> Callable:
    """``optax.cosine_decay_schedule(lr, decay_steps)``: the k-th update
    (k from 0) uses ``lr * 0.5 * (1 + cos(pi * min(k, E) / E))``. A Python
    int gives a float; a device count gives an f32 tensor on its device,
    computed as optax computes it."""

    def schedule(count):
        if isinstance(count, torch.Tensor):
            k = torch.clamp(count, max=decay_steps).to(torch.float32)
            return lr * (0.5 * (1.0 + torch.cos(math.pi * k / decay_steps)))
        k = min(count, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * k / decay_steps))

    return schedule


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # int32 scalar on the device: updates taken so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], AdamState]
    update: Callable  # (grads, state, params) -> (updates, state)


def make_optimizer(
    lr: float,
    grad_clip: Optional[float] = None,
    schedule: str = "plateau",
    epochs: int = 0,
) -> GradientTransformation:
    """Adam with optional global-norm clipping, as
    ``optax.chain(clip_by_global_norm, adam(sched))``. For 'cosine' the
    schedule is baked in; for 'plateau' the caller multiplies the update by
    ``PlateauState.scale`` (:func:`scale_updates`). The JAX version's
    ``weight_decay`` (the CV solver's) is not yet ported."""
    sched = (cosine_decay_schedule(lr, max(epochs, 1)) if schedule == "cosine"
             else (lambda count: lr))

    def init(params: Sequence[torch.Tensor]) -> AdamState:
        device = params[0].device if len(params) else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        """(updates, state): ``state``'s moments and count are updated in
        place and it is returned as it came. optax's ``scale_by_adam`` in
        its order of operations, on multi-tensor ops (one launch or two
        each for all the leaves):
        ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
        ``step * (mu / bc1) / (sqrt(nu / bc2) + eps)``."""
        g = list(grads)
        if grad_clip is not None and grad_clip > 0:
            g, _ = clip_grads(g, grad_clip)
        step = -sched(state.count)
        state.count.add_(1)
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, torch._foreach_mul(g, 1.0 - B1))
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2))
        bc1 = 1.0 - torch.pow(B1, state.count)
        bc2 = 1.0 - torch.pow(B2, state.count)
        updates = torch._foreach_div(state.mu, bc1)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, step)
        return updates, state

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates) -> None:
    """params += updates, in place (one multi-tensor op)."""
    torch._foreach_add_(list(params), list(updates))


class PlateauState(NamedTuple):
    best: torch.Tensor  # best loss seen
    bad_epochs: torch.Tensor  # epochs since last improvement
    scale: torch.Tensor  # multiplicative lr scale


def plateau_init(device=None) -> PlateauState:
    return PlateauState(
        best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        bad_epochs=torch.tensor(0, dtype=torch.int32, device=device),
        scale=torch.tensor(1.0, dtype=torch.float32, device=device),
    )


@torch.no_grad()
def plateau_update(
    state: PlateauState,
    loss: torch.Tensor,
    factor: float = 0.9,
    patience: int = 1000,
    threshold: float = 1e-4,
    min_scale: float = 1e-8,
) -> PlateauState:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold_mode='rel'): improvement means loss < best * (1 - threshold);
    after `patience` consecutive non-improvements, scale *= factor."""
    loss = loss.detach().to(torch.float32)
    improved = loss < state.best * (1.0 - threshold)
    best = torch.where(improved, loss, state.best)
    bad = torch.where(improved, torch.zeros_like(state.bad_epochs),
                      state.bad_epochs + 1)
    trip = bad > patience
    scale = torch.where(trip, torch.clamp(state.scale * factor, min=min_scale),
                        state.scale)
    bad = torch.where(trip, torch.zeros_like(bad), bad)
    return PlateauState(best=best, bad_epochs=bad, scale=scale)


def scale_updates(updates, scale: torch.Tensor):
    return [u * scale for u in updates]
