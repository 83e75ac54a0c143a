"""The port's parameter-shift estimator (qcpinn_tpu_torch/train/hardware_grad.py)
against the port's autograd and JAX's make_hw_apply, its cost accounting,
its unbiasedness under shots, DVSolver.hw_apply_fn, and one
``make_train_step`` step in parameter-shift mode against backprop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import DVCircuit as JCircuit
from qcpinn_tpu.ops import NoiseModel as JNoise
from qcpinn_tpu.train.hardware_grad import evals_per_step as j_evals
from qcpinn_tpu.train.hardware_grad import make_hw_apply as j_make_hw_apply
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.models import DVSolver as TSolver
from qcpinn_tpu_torch.ops import NoiseModel, ansatz
from qcpinn_tpu_torch.ops.circuit import DVCircuit
from qcpinn_tpu_torch.physics import get_operator
from qcpinn_tpu_torch.train import optim
from qcpinn_tpu_torch.train.hardware_grad import evals_per_step, make_hw_apply
from qcpinn_tpu_torch.train.loop import diffusion_terms, make_train_step


def _inputs(ansatz_name, n=3, b=4, seed=0):
    jc, tc = JCircuit(n, 1, ansatz_name), DVCircuit(n, 1, ansatz_name)
    params = np.asarray(jc.init_params(jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).uniform(-1, 1, (b, n)).astype(np.float32)
    return jc, tc, params, x


@pytest.mark.parametrize("ansatz_name", ["cascade", "cross_mesh"])
def test_parameter_shift_matches_autograd_and_jax(ansatz_name):
    """shots=None: the two-term (cascade) and four-term (cross_mesh's crz)
    rules against the port's autograd and JAX's make_hw_apply, atol 2e-4."""
    jc, tc, params, x = _inputs(ansatz_name, n=2)
    noise = NoiseModel(depolarizing=0.05, per_gate=0.01)
    jnoise = JNoise(depolarizing=0.05, per_gate=0.01)
    jhw = j_make_hw_apply(jc, shots=None, noise=jnoise)
    jg = jax.jit(jax.grad(lambda p, xx: jnp.sum(jhw(p, xx, jax.random.PRNGKey(1)) ** 2),
                          argnums=(0, 1)))(jnp.asarray(params), jnp.asarray(x))
    hw = make_hw_apply(tc, shots=None, noise=noise)
    p = torch.tensor(params, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    got = torch.autograd.grad(torch.sum(hw(p, xt) ** 2), (p, xt))
    ref = torch.autograd.grad(torch.sum(tc.apply(p, xt, noise=noise) ** 2), (p, xt))
    for a, r, j in zip(got, ref, jg):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=2e-4)
    np.testing.assert_allclose(hw(p, xt).detach().numpy(),
                               tc.apply(p, xt, noise=noise).detach().numpy(), atol=1e-6)


def test_parameter_shift_with_shots_is_unbiased():
    """shots=2048: the mean of 24 sampled gradients within 0.05 of the exact
    gradient (tests/test_hardware_modes.py:52-65)."""
    _, tc, params, x = _inputs("cascade", n=2, b=2)
    hw = make_hw_apply(tc, shots=2048)
    p = torch.tensor(params, requires_grad=True)
    xt = torch.tensor(x)
    (g_exact,) = torch.autograd.grad(torch.sum(tc.apply(p, xt)), (p,))
    gen = torch.Generator().manual_seed(3)
    gs = torch.stack([torch.autograd.grad(torch.sum(hw(p, xt, gen)), (p,))[0]
                      for _ in range(24)])
    assert float((gs.mean(0) - g_exact).abs().max()) < 0.05
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        hw(p, xt)
    with pytest.raises(ValueError, match="angle encoding"):
        make_hw_apply(DVCircuit(2, 1, "cascade", encoding="amplitude"), None)


def test_evals_per_step_matches_jax():
    assert evals_per_step(DVCircuit(4, 1, "cascade")) == 41
    for name in ansatz.BUILDERS:
        for n, layers in ((3, 1), (4, 2)):
            assert evals_per_step(DVCircuit(n, layers, name)) == j_evals(
                JCircuit(n, layers, name)), (name, n, layers)


def test_dv_solver_hw_apply_fn_matches_autograd():
    model = TSolver(TConfig(num_qubits=3, classic_network=(3, 6, 1), q_ansatz="cross_mesh",
                            seed=2, noise_readout=0.02), device="cpu")
    x = torch.rand(5, 3, generator=torch.Generator().manual_seed(0))
    params = list(model.parameters())
    want = torch.autograd.grad(torch.sum(model(x) ** 2), params)
    apply = model.hw_apply_fn(None)
    got = torch.autograd.grad(torch.sum(apply(x) ** 2), params)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-4)


def _recording_optimizer(seen):
    """A GradientTransformation that records the gradients and moves
    nothing."""

    def init(params):
        return optim.AdamState(torch.zeros((), dtype=torch.int32), [], [])

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return [torch.zeros_like(g) for g in grads], state

    return optim.GradientTransformation(init, update)


def test_parameter_shift_step_matches_backprop():
    """One make_train_step step with shots_apply = hw_apply_fn(None)
    against backprop on the same points: loss to 1e-6, gradients within
    2e-4."""
    results = {}
    for mode in ("backprop", "parameter-shift"):
        cfg = TConfig(num_qubits=2, classic_network=(3, 6, 1), q_ansatz="cascade", seed=7,
                      gradient_mode=mode)
        model = TSolver(cfg, device="cpu")
        seen = []
        opt = _recording_optimizer(seen)
        shots_apply = model.hw_apply_fn(None) if mode == "parameter-shift" else None
        step_fn, _ = make_train_step(model, get_operator("diffusion", "fwd"),
                                     diffusion_terms(tdd.gaussian_pulse_samplers(), 9),
                                     opt, cfg, shots_apply=shots_apply)
        params = [p for p in model.parameters() if p.requires_grad]
        gen = torch.Generator().manual_seed(1)
        _, _, metrics = step_fn(params, opt.init(params), optim.plateau_init(), gen)
        results[mode] = (float(metrics["loss"]), seen[0])
    (l_bp, g_bp), (l_ps, g_ps) = results["backprop"], results["parameter-shift"]
    assert abs(l_ps - l_bp) <= 1e-6 * max(abs(l_bp), 1.0)
    for a, r in zip(g_ps, g_bp):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-4)
