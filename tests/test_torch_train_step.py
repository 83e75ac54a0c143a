"""One bench train step of the port against the JAX package, and the port's
clip + Adam against optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models.dv_fourier import DVFourierSolver as JSolver
from qcpinn_tpu.physics.streams import dv_diffusion_residual_streams as j_streams
from qcpinn_tpu_torch import bench
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.ops import block_kernel as bk
from qcpinn_tpu_torch.train.optim import adam, clip_by_global_norm


def test_bench_step_loss_and_grads_match_jax():
    """The bench loss (streams residual + both value terms, 2/4/2) at
    n = 10: the port's block_kernel engine (its plain versions, on the CPU)
    against the JAX package's block engine, same params, same points."""
    cfg = dict(num_qubits=10, num_quantum_layers=1, q_ansatz="cross_mesh",
               classic_network=(3, 16, 1), seed=5)
    jm = JSolver(JConfig(**cfg))
    jm.use_pallas(backend="block")
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    Xr = rng.uniform(0, 1, size=(16, 3)).astype(np.float32)
    Xb = rng.uniform(0, 1, size=(5, 3)).astype(np.float32)
    Xb[:, 1] = 0.0  # the x = 0 boundary
    Xi = rng.uniform(0, 1, size=(5, 3)).astype(np.float32)
    Xi[:, 0] = 0.0  # t = 0
    nb = Xb.shape[0]

    def j_loss(p):
        _, r = j_streams(jm, p, jnp.asarray(Xr))
        pv = jm.apply(p, jnp.concatenate([jnp.asarray(Xb), jnp.asarray(Xi)]))
        return (
            2.0 * jnp.mean((r - jdd.r_true(jnp.asarray(Xr))) ** 2)
            + 4.0 * jnp.mean((pv[:nb] - jdd.u(jnp.asarray(Xb))) ** 2)
            + 2.0 * jnp.mean((pv[nb:] - jdd.u(jnp.asarray(Xi))) ** 2)
        )

    l_ref, g_ref = jax.jit(jax.value_and_grad(j_loss))(params)

    model = bench.build(batch=16, n_qubits=10, hidden=16, backend="block_kernel",
                        seed=5, device="cpu").model
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    T = torch.as_tensor
    bk.reset_launches()
    loss = bench.bench_loss(
        model, T(Xr), tdd.r_true(T(Xr)), T(Xb), tdd.u(T(Xb)), T(Xi), tdd.u(T(Xi)))
    loss.backward()
    assert bk.LAUNCHES["block_chain_fwd_ref"] == 2
    assert bk.LAUNCHES["block_chain_bwd_ref"] == 2
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=2e-5)
    got = jax.tree_util.tree_leaves(grads_to_jax_layout(model))
    for a, want in zip(got, jax.tree_util.tree_leaves(g_ref)):
        scale = max(float(jnp.max(jnp.abs(want))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(want), atol=2e-4 * scale)


def test_clip_and_adam_match_optax():
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32),
          rng.normal(size=(5,)).astype(np.float32)]
    # global norms above and below the clip threshold
    grads = [[s * rng.normal(size=a.shape).astype(np.float32) for a in p0]
             for s in (3.0, 0.1, 1.5)]
    lr = 5e-3

    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    jp = [jnp.asarray(a) for a in p0]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
    topt = adam(tp, lr)
    for g in grads:
        upd, state = opt.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        clip_by_global_norm(tp, 1.0)
        topt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6)


def test_clip_by_global_norm_formula():
    g = torch.tensor([3.0, 4.0])  # norm 5
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = g.clone()
    norm = clip_by_global_norm([p], 1.0)
    assert float(norm) == 5.0
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.8], rtol=1e-7)
    p.grad = torch.tensor([0.3, 0.4])  # norm 0.5: untouched, no epsilon
    clip_by_global_norm([p], 1.0)
    np.testing.assert_array_equal(p.grad.numpy(), np.float32([0.3, 0.4]))


def test_sampler_boxes_and_targets():
    gen = torch.Generator().manual_seed(0)
    s = tdd.Sampler(tdd._box([[0, 0, 0], [1, 0, 1]]), tdd.u)
    X, y = s.sample(gen, 64)
    assert X.shape == (64, 3) and y.shape == (64, 1)
    assert float(X[:, 1].abs().max()) == 0.0
    Xn = X.numpy()
    for t_fn, j_fn in ((tdd.u, jdd.u), (tdd.r, jdd.r), (tdd.r_true, jdd.r_true),
                       (tdd.u_xx, jdd.u_xx), (tdd.u_yy_true, jdd.u_yy_true)):
        np.testing.assert_allclose(
            t_fn(X).numpy(), np.asarray(j_fn(jnp.asarray(Xn))), rtol=1e-5, atol=1e-6)
