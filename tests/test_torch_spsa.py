"""The port's SPSA (qcpinn_tpu_torch/train/spsa.py) against the JAX
package's train/spsa.py: one spsa_step and one spsa_split_step on the DV
4q diffusion loss at fixed points (shots=None), with the Rademacher
vector JAX's key gives fed to the port's update; the quadratic and the
lr_scale cases of tests/test_hardware_modes.py; and the SPSA modes of
make_train_step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models import DVSolver as JSolver
from qcpinn_tpu.physics import get_operator as j_get_operator
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu.train import spsa as jspsa
from qcpinn_tpu_torch.bridge import params_from_jax, params_to_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.models import DVSolver as TSolver
from qcpinn_tpu_torch.physics import get_operator as t_get_operator
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train import spsa as tspsa
from qcpinn_tpu_torch.train.loop import diffusion_terms, make_train_step

CFG = dict(num_qubits=4, classic_network=(3, 8, 1), q_ansatz="cascade", seed=7)
K = 3.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_problem():
    """(params, the JAX loss jitted, points, targets, weights): the weighted
    2/4/2 diffusion loss on fixed points (residual 12, BC and IC 4), built
    once for both tests."""
    jm = JSolver(JConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.PRNGKey(4))
    rng = np.random.default_rng(8)
    X = {"res": rng.uniform(size=(12, 3)), "bc": rng.uniform(size=(4, 3)),
         "ic": rng.uniform(size=(4, 3))}
    X["bc"][:, 1] = 0.0
    X["ic"][:, 0] = 0.0
    X = {k: v.astype(np.float32) for k, v in X.items()}
    Y = {k: np.asarray(jax.jit(jdd.r if k == "res" else jdd.u)(jnp.asarray(X[k])))
         for k in X}
    W = {"res": 2.0, "bc": 4.0, "ic": 2.0}
    jop = j_get_operator("diffusion", "fwd")

    def jloss(p, key):
        per = {"res": jnp.mean((jop(lambda x: jm.apply(p, x), jnp.asarray(X["res"]))[1]
                                - Y["res"]) ** 2)}
        for k in ("bc", "ic"):
            per[k] = jnp.mean((jm.apply(p, jnp.asarray(X[k])) - Y[k]) ** 2)
        return sum(W[k] * per[k] for k in per), per

    return params, jax.jit(jloss), X, Y, W


def _problem():
    """(JAX params, JAX loss, a fresh port model with the same weights, the
    port's loss on the same points)."""
    params, jloss, X, Y, W = _jax_problem()
    tm = TSolver(TConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    top = t_get_operator("diffusion", "fwd")

    def tloss(key):
        per = {"res": torch.mean((top(tm, torch.tensor(X["res"]))[1]
                                  - torch.tensor(Y["res"])) ** 2)}
        for k in ("bc", "ic"):
            per[k] = torch.mean((tm(torch.tensor(X[k])) - torch.tensor(Y[k])) ** 2)
        return sum(W[k] * per[k] for k in per), per

    return params, jloss, tm, tloss


def _port_order(tm, jax_tree):
    """A JAX-layout tree as the port's tensors, in model.parameters() order."""
    sd = params_from_jax(_np(jax_tree))
    return [sd[n] for n, _ in tm.named_parameters()]


def _assert_params(tm, want):
    got = params_to_jax(tm)
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np(want))):
        np.testing.assert_allclose(a, w, atol=1e-5)


def test_spsa_step_matches_jax():
    params, jloss, tm, tloss = _problem()
    cfg = tspsa.SPSAConfig()
    key = jax.random.PRNGKey(5)
    new, loss, aux = jax.jit(lambda p: jspsa.spsa_step(
        jloss, p, jnp.asarray(K), key, jspsa.SPSAConfig(), has_aux=True))(params)
    delta = jspsa._rademacher_like(jax.random.split(key, 3)[0], params)
    leaves = list(tm.parameters())
    got_loss, got_aux = tspsa._spsa_update(tloss, leaves, torch.tensor(K), _port_order(tm, delta),
                                           torch.Generator(), cfg, True, 1.0)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=2e-5)
    for k in aux:
        np.testing.assert_allclose(float(got_aux[k]), float(aux[k]), rtol=2e-5)
    _assert_params(tm, new)
    assert not any(p.grad is not None for p in tm.parameters())


def test_spsa_split_step_matches_jax():
    params, jloss, tm, tloss = _problem()
    key = jax.random.PRNGKey(6)
    q_part, c_part = jspsa.split_params(params)
    j_opt = jopt.make_optimizer(5e-3)
    new, _, loss, aux = jax.jit(lambda p: jspsa.spsa_split_step(
        jloss, p, jnp.asarray(K), key, jspsa.SPSAConfig(a=5e-3), j_opt,
        j_opt.init(c_part), has_aux=True))(params)
    delta = jspsa._rademacher_like(jax.random.split(key, 4)[0], q_part)
    named = dict(tm.named_parameters())
    t_opt = topt.make_optimizer(5e-3)
    _, c_named = tspsa.split_params(named)
    assert list(tspsa.split_params(named)[0]) == ["q"]
    state = t_opt.init(list(c_named.values()))
    state, got_loss, got_aux = tspsa._spsa_split_update(
        tloss, named, torch.tensor(K), [torch.tensor(np.asarray(delta["q"]))],
        torch.Generator(), tspsa.SPSAConfig(a=5e-3), t_opt, state, ("q",), True, 1.0)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=2e-5)
    for k in aux:
        np.testing.assert_allclose(float(got_aux[k]), float(aux[k]), rtol=2e-5)
    _assert_params(tm, new)
    assert int(state.count) == 1


def test_spsa_minimizes_quadratic():
    target = torch.tensor([0.3, -0.7, 1.1])
    params = {"w": torch.zeros(3)}

    def loss(key):
        return torch.sum((params["w"] - target) ** 2)

    step = tspsa.make_spsa_trainer(loss, tspsa.SPSAConfig(a=0.2, c=0.05))
    gen = torch.Generator().manual_seed(0)
    for k in range(1, 201):
        params, _ = step(params, torch.tensor(float(k)), gen)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.1)


def test_spsa_lr_scale_modulates_gain():
    """lr_scale is the plateau scheduler's hook into SPSA: scale 0 freezes
    the parameters; scale 1 gives the plain update."""
    w = torch.ones(3)

    def loss(key):
        return torch.sum(w**2)

    tspsa.spsa_step(loss, [w], torch.tensor(1.0), torch.Generator().manual_seed(7),
                    tspsa.SPSAConfig(), lr_scale=0.0)
    np.testing.assert_allclose(w.numpy(), 1.0)
    tspsa.spsa_step(loss, [w], 1, torch.Generator().manual_seed(7), tspsa.SPSAConfig(),
                    lr_scale=1.0)
    assert not np.allclose(w.numpy(), 1.0)


@pytest.mark.parametrize("mode", ["spsa", "spsa-split"])
def test_train_step_spsa_modes(mode):
    """make_train_step's SPSA modes: the step counts k on the optimizer
    state, moves the tensors its mode moves, and a balancer is refused."""
    cfg = TConfig(**{**CFG, "num_qubits": 2}, gradient_mode=mode)
    model = TSolver(cfg, device="cpu")
    terms = diffusion_terms(tdd.gaussian_pulse_samplers(), 9)
    opt = topt.make_optimizer(cfg.lr)
    with pytest.raises(ValueError, match="adaptive balancers need gradient_mode='backprop'"):
        make_train_step(model, t_get_operator("diffusion", "fwd"), terms, opt, cfg,
                        balancer="ema")
    step_fn, _ = make_train_step(model, t_get_operator("diffusion", "fwd"), terms, opt, cfg)
    params = list(model.parameters())
    stepped = params if mode == "spsa" else [p for n, p in model.named_parameters() if n != "q"]
    state = opt.init(stepped)
    before = [p.detach().clone() for p in params]
    gen = torch.Generator().manual_seed(0)
    sched = topt.plateau_init()
    for _ in range(2):
        state, sched, metrics = step_fn(params, state, sched, gen)
    assert int(state.count) == 2 and set(metrics) == {"res", "bc", "ic", "loss", "lr_scale"}
    assert all(not torch.equal(a, b) for a, b in zip(params, before))
    assert all(np.isfinite(float(v)) for v in metrics.values())
