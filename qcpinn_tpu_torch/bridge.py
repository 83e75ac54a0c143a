"""Parameter bridge between the JAX package's params pytree and the port's
modules (``DVFourierSolver``, ``DVSolver``, ``ClassicalSolver``), so one set
of weights drives both packages.

JAX trees: ``DVFourierSolver`` is ``{"ff": {"B"}, "pre": [{w, b}, ...],
"skip": [{w, b}], "q": [layers, P], "post": [{w, b}, ...]}``, with an RBF
head also ``"rbf": {c, w, v, a}`` (same layout in both packages);
``DVSolver`` is ``{"pre", "q", "post"}`` alone; ``ClassicalSolver`` is
``{"pre": {w, b}, "hopfield": {"w_q": {w}, "w_k": {w}, "w_v": {w}},
"post": {w, b}}`` (single layers, no bias in the projections);
``Hybrid16QPINN`` is ``{"ff": {"B"}, "coord_proj", "res1", "res2",
"to_quantum", "classical_skip", "post": [{w, b}, ...], "q": [L, n, 3],
"q_norm": {"beta", "gamma"}}``. The loss balancers add ``"loss_log_vars"``
or ``"loss_ema"`` (one scalar a term,
``train/loop.py::inject_balancer_params``), the Czochralski pipeline's
coupled weighting ``"loss_bal": {"log_eps_data"}``. ``w`` is ``[in, out]``; the
module holds ``nn.Linear.weight[out, in]``, so weights transpose on the way.
Leaves cross as numpy arrays.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

_MLPS = ("pre", "skip", "post", "coord_proj", "res1", "res2", "to_quantum",
         "classical_skip")
# groups of named leaves, laid out alike in both packages
_GROUPS = ("rbf", "loss_log_vars", "loss_ema", "q_norm", "loss_bal")


def params_from_jax(tree) -> dict:
    """JAX params tree (numpy leaves) -> a state dict for
    ``model.load_state_dict``."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))  # a copy

    sd = {}

    def linear(prefix, layer):
        sd[f"{prefix}.weight"] = t(np.asarray(layer["w"]).T)
        if "b" in layer:
            sd[f"{prefix}.bias"] = t(layer["b"])

    if "q" in tree:
        sd["q"] = t(tree["q"])
    if "ff" in tree:
        sd["B"] = t(tree["ff"]["B"])
    for name in _MLPS:
        layers = tree.get(name, ())
        if isinstance(layers, dict):  # one layer (the Hopfield baseline)
            linear(name, layers)
        else:
            for i, layer in enumerate(layers):
                linear(f"{name}.{i}", layer)
    for k, layer in tree.get("hopfield", {}).items():
        linear(f"hopfield.{k}", layer)
    for group in _GROUPS:
        for k, leaf in tree.get(group, {}).items():
            sd[f"{group}.{k}"] = t(leaf)
    return sd


def _tree(model: nn.Module, leaf: Callable[[torch.Tensor], np.ndarray]) -> dict:
    """The model's tensors in the JAX tree's layout, ``leaf`` of each."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())

    def linear(prefix):
        layer = {"w": np.ascontiguousarray(leaf(named[f"{prefix}.weight"]).T)}
        if f"{prefix}.bias" in named:
            layer["b"] = leaf(named[f"{prefix}.bias"])
        return layer

    tree = {}
    for name in _MLPS:
        mod = getattr(model, name, None)
        if isinstance(mod, nn.ModuleList):
            tree[name] = [linear(f"{name}.{i}") for i in range(len(mod))]
        elif isinstance(mod, nn.Linear):
            tree[name] = linear(name)
    if "q" in named:
        tree["q"] = leaf(named["q"])
    if "B" in named:
        tree["ff"] = {"B": leaf(named["B"])}
    if isinstance(getattr(model, "hopfield", None), nn.ModuleDict):
        tree["hopfield"] = {k: linear(f"hopfield.{k}") for k in model.hopfield}
    for group in _GROUPS:
        keys = [n[len(group) + 1:] for n in named if n.startswith(group + ".")]
        if keys:
            tree[group] = {k: leaf(named[f"{group}.{k}"]) for k in keys}
    return tree


def params_to_jax(model: nn.Module) -> dict:
    """The model's parameters and buffers as a JAX params tree of numpy
    arrays (copies): the inverse of :func:`params_from_jax`."""
    return _tree(model, lambda t: t.detach().cpu().numpy().copy())


def grads_to_jax_layout(model: nn.Module) -> dict:
    """The module's ``.grad`` fields as a JAX-shaped tree of numpy arrays.
    A buffer (``ff.B``, the EMA balancer's state: ``stop_gradient`` in JAX)
    has zeros, as JAX reports it."""

    def grad(t):
        g = t.grad if isinstance(t, nn.Parameter) else torch.zeros_like(t)
        return g.detach().cpu().numpy()

    return _tree(model, grad)
