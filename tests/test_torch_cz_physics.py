"""The port's Czochralski residuals (physics/cylindrical.py, reverse mode;
physics/operators_fwd.py::cz_residuals_fwd, nested jvps) and the circuit's
parameter-shift estimator (train/hardware_grad.py::make_hw_apply_cz)
against the JAX package's and against each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.models import czochralski as jcz
from qcpinn_tpu.ops import NoiseModel as JNoise
from qcpinn_tpu.physics.cylindrical import cz_residuals as j_rev
from qcpinn_tpu.physics.operators_fwd import cz_residuals_fwd as j_fwd
from qcpinn_tpu.train.hardware_grad import evals_per_step_cz as j_evals
from qcpinn_tpu.train.hardware_grad import make_hw_apply_cz as j_make_hw_apply_cz
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.models import czochralski as tcz
from qcpinn_tpu_torch.ops import NoiseModel
from qcpinn_tpu_torch.physics.cylindrical import cz_residuals
from qcpinn_tpu_torch.physics.operators_fwd import cz_residuals_fwd
from qcpinn_tpu_torch.train.hardware_grad import evals_per_step_cz, make_hw_apply_cz

# the real data's pressure_coeff (artifacts/cz_real_*.stats.json) and the
# reference's Re, Pr, Gr
ARGS = (134128.54054426512, 15.0, 28.463, 8000.0)


@pytest.fixture(scope="module")
def models():
    """The two packages' models on bridged weights (3 qubits, 2 layers,
    width 8), the points (r from 0, where the clamp at 1e-4 acts, to 1),
    and JAX's residuals in both modes."""
    jm = jcz.Hybrid16QPINN(n_qubits=3, n_layers=2, width=8, remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    tm = tcz.Hybrid16QPINN(3, 2, width=8, remat=False, device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    x = np.random.default_rng(0).uniform(0, 1, (8, 2)).astype(np.float32)
    x[0, 0] = 0.0
    jax_res = [jax.jit(lambda X, f=jfn: f(lambda Xp: jm.apply(tree, Xp), X, *ARGS))(
        jnp.asarray(x)) for jfn in (j_rev, j_fwd)]
    return tm, x, jax_res


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_residuals_match_jax(models, mode):
    """Each term and the total against JAX's of the same mode and of the
    other, rtol 5e-3 / atol 1e-5 (tests/test_operators_fwd.py:73-85)."""
    tm, x, jax_res = models
    fn = cz_residuals if mode == "rev" else cz_residuals_fwd
    total, terms = fn(tm, torch.tensor(x), *ARGS)
    for jtotal, jterms in jax_res:
        assert set(terms) == set(jterms)
        for k in terms:
            np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=5e-3, atol=1e-5)


def test_rev_and_fwd_agree_and_give_the_same_gradient(models):
    tm, x, _ = models
    xt = torch.tensor(x)
    t_rev, terms_rev = cz_residuals(tm, xt, *ARGS)
    t_fwd, terms_fwd = cz_residuals_fwd(tm, xt, *ARGS)
    for k in terms_rev:
        np.testing.assert_allclose(float(terms_fwd[k]), float(terms_rev[k]), rtol=5e-3, atol=1e-5)
    params = [p for p in tm.parameters()]
    g_rev = torch.autograd.grad(t_rev, params)
    g_fwd = torch.autograd.grad(t_fwd, params)
    for a, b in zip(g_fwd, g_rev):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= 5e-3 * scale
    assert all(torch.isfinite(g).all() for g in g_fwd)


@pytest.mark.parametrize("noisy", [False, True])
def test_parameter_shift_matches_autograd_and_jax(noisy):
    """shots=None: the Rot weights' two-term rule and the per-occurrence
    input shifts (RY encoding, each reupload RZ with its 1/2) against
    autograd and JAX's make_hw_apply_cz, atol 2e-4
    (tests/test_hardware_modes.py:68-88); the chunks of the shifted
    evaluations do not change the result."""
    n, L = 3, 2
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 2 * np.pi, (L, n, 3)).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, (3, n)).astype(np.float32)
    noise = NoiseModel(0.05, 0.02, 0.01) if noisy else None
    jnoise = JNoise(0.05, 0.02, 0.01) if noisy else None
    q = tcz.CzQuantumLayer(n, L)
    jhw = j_make_hw_apply_cz(jcz.CzQuantumLayer(n, L), None, noise=jnoise)
    jg = jax.jit(jax.grad(lambda a, b: jnp.sum(jhw(a, b, jax.random.PRNGKey(0)) ** 2),
                          argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(x))
    wt, xt = torch.tensor(w, requires_grad=True), torch.tensor(x, requires_grad=True)
    ref = torch.autograd.grad(torch.sum(q.apply(wt, xt, noise=noise) ** 2), (wt, xt))
    for chunk in (7, 32):
        hw = make_hw_apply_cz(q, None, noise=noise, chunk=chunk)
        out = hw(wt, xt)
        np.testing.assert_allclose(out.detach().numpy(),
                                   q.apply(wt, xt, noise=noise).detach().numpy(), atol=1e-6)
        got = torch.autograd.grad(torch.sum(out ** 2), (wt, xt))
        for a, r, j in zip(got, ref, jg):
            np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-4)
            np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=2e-4)


def test_parameter_shift_with_shots_is_unbiased():
    """shots=2048: the mean of 24 sampled gradients within 0.05 of the
    exact gradient; a sampled call needs its generator."""
    n, L = 3, 1
    rng = np.random.default_rng(4)
    w = torch.tensor(rng.uniform(0, 2 * np.pi, (L, n, 3)).astype(np.float32), requires_grad=True)
    x = torch.tensor(rng.uniform(-np.pi, np.pi, (2, n)).astype(np.float32), requires_grad=True)
    q = tcz.CzQuantumLayer(n, L)
    g_exact = torch.autograd.grad(torch.sum(q.apply(w, x)), (w, x))
    hw = make_hw_apply_cz(q, 2048)
    gen = torch.Generator().manual_seed(5)
    gs = [torch.autograd.grad(torch.sum(hw(w, x, gen)), (w, x)) for _ in range(24)]
    for i in range(2):
        mean = torch.stack([g[i] for g in gs]).mean(0)
        assert float((mean - g_exact[i]).abs().max()) < 0.05
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        hw(w, x)


@pytest.mark.parametrize("n,L", [(16, 2), (4, 1), (5, 3)])
def test_evals_per_step_matches_jax(n, L):
    assert evals_per_step_cz(tcz.CzQuantumLayer(n, L)) == j_evals(jcz.CzQuantumLayer(n, L))
    if (n, L) == (16, 2):
        assert evals_per_step_cz(tcz.CzQuantumLayer(n, L)) == 289
