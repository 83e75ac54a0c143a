"""Parameter bridge between the JAX package's params pytree and the port's
``DVFourierSolver`` module, so one set of weights drives both packages.

JAX tree: ``{"ff": {"B"}, "pre": [{w, b}, ...], "skip": [{w, b}],
"q": [layers, P], "post": [{w, b}, ...]}`` with ``w[in, out]``, and with an
RBF head also ``"rbf": {c, w, v, a}`` (same layout in both packages); the
module holds ``nn.Linear.weight[out, in]``, so weights transpose on the way.
Leaves cross as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

_MLPS = ("pre", "skip", "post")


def params_from_jax(tree) -> dict:
    """JAX params tree (numpy leaves) -> a state dict for
    ``model.load_state_dict``."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))  # a copy

    sd = {"B": t(tree["ff"]["B"]), "q": t(tree["q"])}
    for name in _MLPS:
        for i, layer in enumerate(tree[name]):
            sd[f"{name}.{i}.weight"] = t(np.asarray(layer["w"]).T)
            sd[f"{name}.{i}.bias"] = t(layer["b"])
    for k, leaf in tree.get("rbf", {}).items():
        sd[f"rbf.{k}"] = t(leaf)
    return sd


def grads_to_jax_layout(model) -> dict:
    """The module's ``.grad`` fields as a JAX-shaped tree of numpy arrays.
    ``ff.B`` is a buffer (``stop_gradient`` in JAX), so its entry is zeros,
    as JAX reports it."""

    def np_(t):
        return t.detach().cpu().numpy()

    def mlp(layers):
        return [
            {"w": np_(layer.weight.grad).T, "b": np_(layer.bias.grad)}
            for layer in layers
        ]

    tree = {
        "ff": {"B": np.zeros(tuple(model.B.shape), np.float32)},
        "pre": mlp(model.pre),
        "skip": mlp(model.skip),
        "q": np_(model.q.grad),
        "post": mlp(model.post),
    }
    if getattr(model, "rbf", None) is not None:
        tree["rbf"] = {k: np_(p.grad) for k, p in model.rbf.items()}
    return tree
