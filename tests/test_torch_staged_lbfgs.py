"""The port's staged recipe (qcpinn_tpu_torch/train/staged.py) and L-BFGS
refinement (train/lbfgs.py) against the JAX package's: stage 1 leaves the
quantum tensors bit-equal, stage 2 trains the layers last-first with the
shots escalating and learns past the noise floor through parameter-shift,
the noise estimate shrinks with the shots; L-BFGS reaches JAX's minimiser,
chunked equals unchunked, polishes the small regression of
tests/test_lbfgs.py, and its first losses match optax's;
make_fixed_batch_loss equals JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models import DVSolver as JSolver
from qcpinn_tpu.train.lbfgs import lbfgs_refine as j_lbfgs
from qcpinn_tpu.train.lbfgs import make_fixed_batch_loss as j_fixed
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.models import DVSolver as TSolver
from qcpinn_tpu_torch.ops.circuit import DVCircuit
from qcpinn_tpu_torch.train.lbfgs import lbfgs_refine, make_fixed_batch_loss
from qcpinn_tpu_torch.train.staged import (StagedConfig, _layer_mask, estimate_loss_noise,
                                           make_hw_data_loss, train_classical_only,
                                           train_quantum_layerwise)


def _toy(layers=3, n=2):
    cfg = TConfig(num_qubits=n, num_quantum_layers=layers, classic_network=(2, 6, 1),
                  q_ansatz="cascade", seed=1)
    model = TSolver(cfg, device="cpu")
    gen = torch.Generator().manual_seed(9)
    X = torch.rand(16, 2, generator=gen)
    return model, X, torch.sin(X[:, :1] * 3)


def test_classical_then_layerwise():
    """Stage 1 moves every tensor but the quantum block, which stays
    bit-equal; stage 2 visits layers [2, 1, 0] with the shots escalating to
    the maximum and moves only the quantum block
    (tests/test_hardware_modes.py:292-337)."""
    model, X, Y = _toy()
    cfg = StagedConfig(classical_epochs=30, layer_epochs=8, initial_shots=256,
                       max_shots=512, noise_evals=3, seed=0)
    q0 = model.q.detach().clone()
    pre0 = [p.detach().clone() for p in model.pre.parameters()]
    model, hist = train_classical_only(lambda key: torch.mean((model(X) - Y) ** 2), model,
                                       cfg=cfg)
    assert hist[-1] < hist[0] and len(hist) == 30
    assert torch.equal(model.q, q0)
    assert all(not torch.equal(a, b) for a, b in zip(model.pre.parameters(), pre0))
    mask = _layer_mask(model, "q", 1)
    assert float(mask[[n for n, _ in model.named_parameters()].index("q")].sum(1)[1]) == \
        model.q.shape[1] and sum(float(m.sum()) for m in mask) == model.q.shape[1]
    pre1 = [p.detach().clone() for p in model.pre.parameters()]
    model, report = train_quantum_layerwise(make_hw_data_loss(model.hw_apply_fn, X, Y), model,
                                            num_layers=3, cfg=cfg)
    assert [r["layer"] for r in report] == [2, 1, 0]
    assert [lv["shots"] for lv in report[0]["levels"]] == [256, 512]
    assert all(torch.equal(a, b) for a, b in zip(model.pre.parameters(), pre1))
    assert float((model.q - q0).abs().max().detach()) > 0


def test_layerwise_parameter_shift_learns_beyond_noise_floor():
    """The wired stage-2 path (hw_apply_fn -> make_hw_data_loss ->
    train_quantum_layerwise) moves the quantum weights and cuts the loss by
    much more than the measured shot-noise floor: the target differs from
    the model in its quantum weights alone."""
    model, X, _ = _toy(layers=2)
    q0 = model.q.detach().clone()
    with torch.no_grad():
        model.q.add_(0.7 * torch.randn(q0.shape, generator=torch.Generator().manual_seed(5)))
        Y = model(X)
        model.q.copy_(q0)
    cfg = StagedConfig(layer_epochs=10, initial_shots=1024, max_shots=1024, noise_evals=4,
                       lr_quantum=0.1, seed=0)
    with torch.no_grad():
        exact0 = float(torch.mean((model(X) - Y) ** 2))
    model, report = train_quantum_layerwise(make_hw_data_loss(model.hw_apply_fn, X, Y), model,
                                            num_layers=2, cfg=cfg)
    assert float((model.q - q0).abs().max().detach()) > 0.05
    first = report[0]["levels"][0]
    assert first["start"] - first["best"] > 2.0 * first["sigma"], first
    with torch.no_grad():
        exact1 = float(torch.mean((model(X) - Y) ** 2))
    assert exact1 < 0.5 * exact0, (exact0, exact1)


def test_estimate_loss_noise_shrinks_with_shots():
    circ = DVCircuit(2, 1, "cascade")
    params = circ.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(8, 2, generator=torch.Generator().manual_seed(1))

    def make(shots):
        return lambda key: torch.mean(circ.apply(params, x, shots=shots, key=key))

    _, small = estimate_loss_noise(make(64), torch.Generator().manual_seed(2), 8)
    _, big = estimate_loss_noise(make(4096), torch.Generator().manual_seed(2), 8)
    assert big < small


def test_lbfgs_quadratic_matches_jax():
    A = np.diag([1.0, 10.0, 100.0]).astype(np.float32)
    b = np.array([1.0, -2.0, 3.0], np.float32)
    pj, lj = j_lbfgs(lambda p: 0.5 * p @ jnp.asarray(A) @ p - jnp.asarray(b) @ p,
                     jnp.zeros(3), steps=30)
    At, bt = torch.tensor(A), torch.tensor(b)
    p, losses = lbfgs_refine(lambda p: 0.5 * p @ At @ p - bt @ p, torch.zeros(3), steps=30)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.linalg.solve(A, b), atol=1e-4)
    np.testing.assert_allclose(losses[:3].numpy(), np.asarray(lj)[:3], rtol=1e-3, atol=1e-7)
    assert losses.shape == (30,) and losses[-1] < losses[0]


def test_lbfgs_chunked_matches_unchunked():
    def loss(p):
        return torch.sum((p - 2.0) ** 4 + 0.5 * p**2)

    p0 = torch.tensor([5.0, -3.0])
    p_a, l_a = lbfgs_refine(loss, p0, steps=24)
    p_b, l_b = lbfgs_refine(loss, p0, steps=24, chunk=6)
    np.testing.assert_allclose(p_a.numpy(), p_b.numpy(), atol=1e-6)
    assert torch.equal(l_a, l_b) and torch.equal(p0, torch.tensor([5.0, -3.0]))
    pj, _ = j_lbfgs(lambda p: jnp.sum((p - 2.0) ** 4 + 0.5 * p**2), jnp.asarray([5.0, -3.0]),
                    steps=24)
    np.testing.assert_allclose(p_a.numpy(), np.asarray(pj), atol=1e-4)


def test_lbfgs_polishes_small_regression():
    """tests/test_lbfgs.py:34-54 on the same data and start: under 1e-4
    after 150 iterations, and the first three losses as optax's."""
    X = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (128, 2)))
    y = np.sin(3.0 * X[:, :1]) * X[:, 1:2]
    w0 = {"w1": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16)) * 0.5),
          "b1": np.zeros(16, np.float32),
          "w2": np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, 1)) * 0.5),
          "b2": np.zeros(1, np.float32)}
    j_loss = j_fixed(lambda p, x: jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"], None,
                     {"sup": (jnp.asarray(X), jnp.asarray(y))}, {"sup": 1.0}, {"sup": "value"})
    t_loss = make_fixed_batch_loss(
        lambda p, x: torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"], None,
        {"sup": (torch.tensor(X), torch.tensor(y))}, {"sup": 1.0}, {"sup": "value"})
    _, lj = j_lbfgs(j_loss, {k: jnp.asarray(v) for k, v in w0.items()}, steps=3)
    params, losses = lbfgs_refine(t_loss, {k: torch.tensor(v) for k, v in w0.items()},
                                  steps=150)
    np.testing.assert_allclose(losses[:3].numpy(), np.asarray(lj), rtol=1e-3)
    assert float(losses[-1]) < 1e-4 and float(losses[-1]) < float(losses[0]) * 1e-3
    assert set(params) == set(w0) and float(t_loss(params)) < 1e-4


def test_make_fixed_batch_loss_matches_jax():
    """A residual term through an operator and a value term, on the DV
    solver with the same weights: rtol 1e-6. The operator is a linear map
    of the model's output: the PDE operators are held to JAX's in
    tests/test_torch_operators.py."""

    def j_op(apply, X):
        u = apply(X)
        return u, 2.0 * u - X[:, :1]

    def t_op(apply, X):
        u = apply(X)
        return u, 2.0 * u - X[:, :1]

    kw = dict(num_qubits=2, classic_network=(3, 6, 1), q_ansatz="cascade", seed=3)
    jm = JSolver(JConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0))
    tm = TSolver(TConfig(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(4)
    Xr, Xb = rng.uniform(size=(6, 3)).astype(np.float32), rng.uniform(size=(3, 3)).astype(
        np.float32)
    yr, yb = np.asarray(jdd.r(jnp.asarray(Xr))), np.asarray(jdd.u(jnp.asarray(Xb)))
    kinds, weights = {"res": "residual", "bc": "value"}, {"res": 2.0, "bc": 4.0}
    want = jax.jit(j_fixed(jm.apply, j_op,
                           {"res": (jnp.asarray(Xr), jnp.asarray(yr)),
                            "bc": (jnp.asarray(Xb), jnp.asarray(yb))}, weights, kinds))(params)
    loss = make_fixed_batch_loss(
        lambda p, X: torch.func.functional_call(tm, p, (X,)), t_op,
        {"res": (torch.tensor(Xr), torch.tensor(yr)), "bc": (torch.tensor(Xb), torch.tensor(yb))},
        weights, kinds)
    got = loss(dict(tm.named_parameters()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
