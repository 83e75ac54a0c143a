"""The port's PDE operators against the JAX package: every reverse-mode
(physics/operators.py) and forward-mode (physics/operators_fwd.py) operator
on a toy DV model and a toy Hopfield model with the same weights, the
closed-form checks of tests/test_physics.py, torch's sum-gradient
convention on a batch-coupled model, and reverse == forward on a
point-decoupled one."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu import physics as jph
from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.data import navier_stokes as jns
from qcpinn_tpu.models import ClassicalSolver as JClassical
from qcpinn_tpu.models import DVSolver as JDV
from qcpinn_tpu_torch import physics as tph
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.data import navier_stokes as tns
from qcpinn_tpu_torch.models import ClassicalSolver as TClassical
from qcpinn_tpu_torch.models import DVSolver as TDV
from qcpinn_tpu_torch.physics import operators as ops

PROBLEMS = {"diffusion": 3, "wave": 2, "klein_gordon": 2, "helmholtz": 2,
            "navier_stokes": 3}


def _points(rng, n, d):
    return rng.uniform(0.05, 0.95, size=(n, d)).astype(np.float32)


def _models(solver, d, out):
    kw = dict(classic_network=(d, 6, out), num_qubits=2, q_ansatz="cascade", seed=3)
    if solver == "DV":
        jm, tm_cls = JDV(JConfig(**kw)), TDV
    else:
        jm, tm_cls = JClassical(JConfig(solver="Classical", **kw)), TClassical
    params = jm.init(jax.random.PRNGKey(1))
    tm = tm_cls(TConfig(solver=solver, **kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("mode", ["rev", "fwd"])
@pytest.mark.parametrize("solver", ["DV", "Classical"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_operator_matches_jax(problem, solver, mode):
    """The same residual from both packages on the same weights and points
    (tests/test_streams.py:31-32's limits). The forward operators on the
    Hopfield model are what the north-star script's classical run uses."""
    d = PROBLEMS[problem]
    jm, params, tm = _models(solver, d, 3 if problem == "navier_stokes" else 1)
    X = _points(np.random.default_rng(4), 8, d)
    want = jph.get_operator(problem, mode)(lambda Xp: jm.apply(params, Xp), jnp.asarray(X))
    got = tph.get_operator(problem, mode)(tm, torch.tensor(X))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=5e-3, atol=5e-4)


def test_reverse_equals_forward_on_a_point_decoupled_model():
    _, _, tm = _models("DV", 3, 1)
    X = torch.tensor(_points(np.random.default_rng(5), 8, 3))
    for problem in ("diffusion", "navier_stokes"):
        if problem == "navier_stokes":
            _, _, tm = _models("DV", 3, 3)
        rev = tph.get_operator(problem, "rev")(tm, X)
        fwd = tph.get_operator(problem, "fwd")(tm, X)
        for a, b in zip(rev, fwd):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       rtol=1e-4, atol=1e-5)


def test_reverse_operator_builds_its_graph_under_no_grad():
    _, _, tm = _models("Classical", 3, 1)
    X = torch.tensor(_points(np.random.default_rng(6), 5, 3))
    with torch.no_grad():
        _, r0 = ops.diffusion_operator(tm, X)
    _, r1 = ops.diffusion_operator(tm, X)
    torch.testing.assert_close(r0, r1.detach(), rtol=0, atol=0)
    r1.sum().backward()  # the residual carries the parameters' graph
    assert tm.pre.weight.grad is not None


# -- closed forms (tests/test_physics.py:17-95, 172-191) --------------------------


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_diffusion_residual_of_analytic_solution_is_forcing(mode, rng):
    X = torch.tensor(_points(rng, 64, 3))
    u_pred, res = tph.get_operator("diffusion", mode)(tdd.u, X)
    np.testing.assert_allclose(u_pred.detach().numpy(), tdd.u(X).numpy(), atol=1e-6)
    np.testing.assert_allclose(res.detach().numpy(), tdd.r_true(X).numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose((tdd.r(X) - tdd.r_true(X)).numpy(),
                               (400.0 * tdd.DEFAULT_D * tdd.u(X)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_diffusion_sine_solution_solves_pure_diffusion(rng):
    X = torch.tensor(_points(rng, 64, 3))
    _, res = ops.diffusion_operator(lambda Xp: tdd.u_sine(Xp, D=0.01), X,
                                    v_x=0.0, v_y=0.0, D=0.01)
    np.testing.assert_allclose(res.detach().numpy(), 0.0, atol=5e-4)
    np.testing.assert_allclose(
        tdd.u_sine(X).numpy(), np.asarray(jdd.u_sine(jnp.asarray(X.numpy()))), atol=1e-6)


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_wave_travelling_solution(mode, rng):
    X = torch.tensor(_points(rng, 32, 2))
    _, res = tph.get_operator("wave", mode)(
        lambda Xp: torch.sin(Xp[:, 1:2] - 2.0 * Xp[:, 0:1]), X)
    np.testing.assert_allclose(res.detach().numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_klein_gordon_closed_form(mode, rng):
    X = torch.tensor(_points(rng, 32, 2))
    u, res = tph.get_operator("klein_gordon", mode)(
        lambda Xp: Xp[:, 0:1] ** 2 + Xp[:, 1:2] ** 2, X)
    np.testing.assert_allclose(res.detach().numpy(), u.detach().numpy() ** 3,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_helmholtz_eigenfunction(mode, rng):
    X = torch.tensor(_points(rng, 32, 2))
    u, res = tph.get_operator("helmholtz", mode)(
        lambda Xp: torch.sin(math.pi * Xp[:, 0:1]) * torch.sin(math.pi * Xp[:, 1:2]), X)
    np.testing.assert_allclose(res.detach().numpy(),
                               (1.0 - 2.0 * math.pi**2) * u.detach().numpy(),
                               rtol=1e-3, atol=1e-4)


def test_navier_stokes_closed_form(rng):
    X = torch.tensor(_points(rng, 8, 3))

    def model(Xp):
        t, x, y = Xp[:, 0:1], Xp[:, 1:2], Xp[:, 2:3]
        u = torch.sin(x) * torch.cos(y) * torch.exp(-t)
        v = -torch.cos(x) * torch.sin(y) * torch.exp(-t)
        p = 0.25 * (torch.cos(2 * x) + torch.cos(2 * y)) * torch.exp(-2 * t)
        return torch.cat([u, v, p], dim=1)

    cont, f_u, _ = ops.navier_stokes_2d_operator(model, X)
    np.testing.assert_allclose(cont.detach().numpy(), 0.0, atol=1e-4)
    mu, rho = 0.00345, 1056.0
    t, x, y = (X[:, i].numpy().astype(np.float64) for i in range(3))
    u = np.sin(x) * np.cos(y) * np.exp(-t)
    v = -np.cos(x) * np.sin(y) * np.exp(-t)
    expect = (-u + u * np.cos(x) * np.cos(y) * np.exp(-t)
              + v * (-np.sin(x) * np.sin(y) * np.exp(-t))
              + (-0.5 * np.sin(2 * x) * np.exp(-2 * t)) / rho - mu * (-2 * u))
    np.testing.assert_allclose(f_u.detach().numpy()[:, 0], expect, rtol=1e-3, atol=1e-4)


def test_taylor_green_is_exact_ns_solution():
    X = torch.tensor(np.random.default_rng(0).uniform(
        [0, 0, 0], [1.0, np.pi, np.pi], (64, 3)).astype(np.float32))
    np.testing.assert_allclose(tns.uvp(X).numpy(), np.asarray(jns.uvp(jnp.asarray(X.numpy()))),
                               rtol=1e-5, atol=1e-4)
    for op in (tph.navier_stokes_2d_operator, tph.navier_stokes_2d_operator_fwd):
        cont, f_u, f_v = op(tns.uvp, X)
        np.testing.assert_allclose(cont.detach().numpy(), 0.0, atol=2e-4)
        np.testing.assert_allclose(f_u.detach().numpy(), 0.0, atol=2e-3)
        np.testing.assert_allclose(f_v.detach().numpy(), 0.0, atol=2e-3)
    _, stacked = tns.residual_stack(tph.navier_stokes_2d_operator)(tns.uvp, X)
    assert stacked.shape == (64, 3) and tns.zero_residuals(X).shape == (64, 3)


def test_batch_coupled_semantics_match_torch_convention(rng):
    """tests/test_physics.py:98-123: for a batch-coupled model the residual
    is torch's grad(u, x, ones) = sum_i du_i/dx_j, not the per-point
    diagonal; held against a dense Hessian."""
    B = 5
    X = torch.tensor(_points(rng, B, 3))
    W = torch.tensor(rng.standard_normal((B, B)).astype(np.float32)) * 0.1

    def coupled(Xp):
        return (W @ torch.tanh(torch.sum(Xp**2, dim=1)))[:, None]

    _, res = ops.diffusion_operator(coupled, X)

    def f_flat(Xf):
        return coupled(Xf.reshape(B, 3)).sum()

    g = torch.func.grad(f_flat)(X.reshape(-1)).reshape(B, 3)
    H = torch.func.hessian(f_flat)(X.reshape(-1)).reshape(B, 3, B, 3)
    expect = (g[:, 0] + g[:, 1] + g[:, 2]
              - 0.01 * (H[:, 1, :, 1].sum(1) + H[:, 2, :, 2].sum(1)))
    np.testing.assert_allclose(res.detach().numpy()[:, 0], expect.numpy(),
                               rtol=1e-4, atol=1e-5)
    # and the JAX package's operator on the same coupled model
    Wj = jnp.asarray(W.numpy())
    _, res_j = jph.diffusion_operator(
        lambda Xp: (Wj @ jnp.tanh(jnp.sum(Xp**2, axis=1)))[:, None], jnp.asarray(X.numpy()))
    np.testing.assert_allclose(res.detach().numpy(), np.asarray(res_j), rtol=1e-4, atol=1e-5)


def test_samplers_match_jax_boxes_and_targets(rng):
    gen = torch.Generator().manual_seed(0)
    for name, s in tdd.gaussian_pulse_samplers().items():
        X, Y = s.sample(gen, 50)
        js = jdd.gaussian_pulse_samplers()[name]
        np.testing.assert_array_equal(s.coords, js.coords)
        assert X.shape == (50, 3) and Y.shape == (50, 1)
        assert bool((X >= torch.tensor(s.coords[0])).all() and (X <= torch.tensor(s.coords[1])).all())
        np.testing.assert_allclose(Y.numpy(), np.asarray(js.func(jnp.asarray(X.numpy()))),
                                   rtol=1e-5, atol=1e-6)
    for name, s in tdd.sine_samplers().items():
        js = jdd.sine_samplers()[name]
        np.testing.assert_array_equal(s.coords, js.coords)
        X, Y = s.sample(gen, 10)
        np.testing.assert_allclose(Y.numpy(), np.asarray(js.func(jnp.asarray(X.numpy()))),
                                   atol=1e-6)
    for name, s in tns.taylor_green_samplers().items():
        np.testing.assert_array_equal(s.coords, jns.taylor_green_samplers()[name].coords)
