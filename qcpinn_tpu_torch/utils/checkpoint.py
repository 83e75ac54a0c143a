"""Checkpoint bundles (port of qcpinn_tpu/utils/checkpoint.py): the same
``<path>.npz`` + ``<path>.json`` (+ ``<path>.stats.json``) format, so a
params bundle moves between the two packages both ways.

The JAX package flattens ``{"opt_state", "params", "sched"}`` with
``jax.tree_util`` (dict keys sorted) into ``leaf_0 ... leaf_{N-1}``. The
port writes the same leaves in the same order: the params through
``bridge.params_to_jax`` (JAX's tree and ``[in, out]`` layout), then the
plateau state (best, bad_epochs, scale; one layout in both packages). An
optimizer state is per package: the port's Adam state and its sample
stream's generator state go under keys of their own (``torch_opt_*``,
``torch_rng``), outside ``num_leaves``, so the JAX loader never reads them
(with a template that holds an opt_state it finds too few leaves and
raises), and the port refuses a JAX bundle that holds optax's state.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..bridge import params_to_jax
from ..train import optim

PACKAGE = "qcpinn_tpu_torch"


def flatten(tree) -> List[np.ndarray]:
    """``jax.tree_util.tree_leaves`` of a tree of dicts, lists, tuples and
    arrays: dict keys sorted, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [np.asarray(tree)]


def unflatten(like, leaves: List[np.ndarray]):
    """The leaves back into ``like``'s structure, in :func:`flatten`'s
    order; each leaf must have its template's shape."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        leaf = next(it)
        if np.shape(leaf) != np.shape(t):
            raise ValueError(f"leaf of shape {np.shape(leaf)} where the template "
                             f"has {np.shape(t)}")
        return leaf

    return build(like)


def _sched_leaves(sched) -> List[np.ndarray]:
    if sched is None:
        return []
    best, bad, scale = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                        else np.asarray(t) for t in sched)
    return [best.astype(np.float32), bad.astype(np.int32), scale.astype(np.float32)]


def save_checkpoint(
    path: str,
    params,
    opt_state: Optional[optim.AdamState] = None,
    sched: Optional[optim.PlateauState] = None,
    loss_history=None,
    stats: Optional[dict] = None,
    config: Optional[dict] = None,
    epoch: int = 0,
    rng: Optional[torch.Tensor] = None,
) -> str:
    """Write ``<path>.npz`` + ``<path>.json`` (+ ``<path>.stats.json`` if
    stats). ``params`` is a model or a JAX-layout tree; ``opt_state`` the
    port's Adam state, ``rng`` its sample generator's state."""
    tree = params_to_jax(params) if isinstance(params, nn.Module) else params
    leaves = flatten(tree) + _sched_leaves(sched)
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    torch_opt = []
    if opt_state is not None:
        torch_opt = [opt_state.count, *opt_state.mu, *opt_state.nu]
        arrays.update({f"torch_opt_{i}": t.detach().cpu().numpy()
                       for i, t in enumerate(torch_opt)})
    if rng is not None:
        arrays["torch_rng"] = rng.cpu().numpy()
    np.savez(path + ".npz", **arrays)

    manifest = {
        "treedef": ("{'opt_state': None, 'params': <JAX params tree>, 'sched': "
                    + ("PlateauState(best, bad_epochs, scale)" if sched is not None
                       else "None") + "}"),
        "num_leaves": len(leaves),
        "epoch": int(epoch),
        "loss_history": [float(v) for v in (loss_history or [])],
        "stats": stats,
        "config": config,
        "package": PACKAGE,
        "num_params_leaves": len(leaves) - len(_sched_leaves(sched)),
        "torch_opt_leaves": len(torch_opt),
        "torch_rng": rng is not None,
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    if stats is not None:
        with open(path + ".stats.json", "w") as f:
            json.dump(stats, f, indent=2, default=str)
    return path + ".npz"


def load_checkpoint(path: str, like) -> dict:
    """Restore a bundle, saved by either package. ``like`` (a model, or a
    JAX-layout params tree) is the template of the params. Returns
    {"bundle": {"params": JAX-layout tree of numpy arrays, "opt_state",
    "sched", "rng"}, "epoch", "loss_history", "stats", "config"}: put the
    params into a model with ``model.load_state_dict(bridge.params_from_jax(
    ...))``, or hand ``{**bundle, "step": epoch}`` to ``train(resume=...)``.
    A JAX bundle that holds an optimizer state raises: that state is in
    optax's layout."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    n = manifest["num_leaves"]
    k = manifest.get("torch_opt_leaves", 0)
    with np.load(path + ".npz", allow_pickle=False) as data:
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        opt_leaves = [torch.tensor(data[f"torch_opt_{i}"]) for i in range(k)]
        rng = torch.tensor(data["torch_rng"]) if manifest.get("torch_rng") else None
    if manifest.get("package") == PACKAGE:
        n_params = manifest["num_params_leaves"]
    else:
        treedef = manifest["treedef"]
        if "'opt_state': None" not in treedef:
            raise ValueError(
                f"{path} holds an optimizer state saved by the JAX package "
                "(optax's layout); an optimizer state loads only into the "
                "package that saved it")
        n_params = n if "'sched': None" in treedef else n - 3
    template = params_to_jax(like) if isinstance(like, nn.Module) else like
    want = len(flatten(template))
    if want != n_params:
        raise ValueError(f"template has {want} params leaves, checkpoint has {n_params}")
    params = unflatten(template, leaves[:n_params])
    sched = None
    if n > n_params:
        best, bad, scale = leaves[n_params:]
        sched = optim.PlateauState(torch.tensor(best), torch.tensor(bad),
                                   torch.tensor(scale))
    opt_state = None
    if k:
        half = (k - 1) // 2
        opt_state = optim.AdamState(opt_leaves[0], opt_leaves[1:1 + half],
                                    opt_leaves[1 + half:])
    return {
        "bundle": {"params": params, "opt_state": opt_state, "sched": sched,
                   "rng": rng},
        "epoch": manifest["epoch"],
        "loss_history": manifest["loss_history"],
        "stats": manifest["stats"],
        "config": manifest["config"],
    }
