"""The port's DVFourierSolver and tangent-stream residuals against the JAX
package, one set of weights bridged across (qcpinn_tpu_torch/bridge.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models.dv_fourier import DVFourierSolver as JSolver
from qcpinn_tpu.physics.streams import dv_diffusion_residual_streams as j_streams
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.models.dv_fourier import DVFourierSolver as TSolver
from qcpinn_tpu_torch.physics.streams import dv_diffusion_residual_streams as t_streams


def _models(n, hidden, mapping=32, seed=3, key=0):
    kw = dict(num_qubits=n, classic_network=(3, hidden, 1), q_ansatz="cross_mesh",
              seed=seed)
    jm = JSolver(JConfig(**kw), mapping_size=mapping)
    params = jm.init(jax.random.PRNGKey(key))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = TSolver(TConfig(**kw), mapping_size=mapping, device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    return jm, params, tm


def test_config_copy_matches():
    import dataclasses

    assert [f.name for f in dataclasses.fields(TConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    assert TConfig().to_dict() == JConfig().to_dict()


@pytest.mark.parametrize("engine,n", [(None, 6), ("block", 6), ("block_kernel", 8)])
def test_dv_fourier_apply_parity(engine, n):
    # block_kernel at n = 8: at n = 6 the seeded Haar epilogue straddles the
    # hi/lo cut, which the kernel plan refuses (the JAX package falls back)
    jm, params, tm = _models(n, 16)
    if engine is not None:
        jm.use_pallas(backend="block" if engine == "block" else "block_pallas",
                      interpret=True)
        tm.use_fused(engine)
    x = np.random.default_rng(1).uniform(0, 1, size=(8, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    got = tm(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_bridge_round_trip():
    _, params, tm = _models(4, 8, mapping=4)
    sd = tm.state_dict()
    np.testing.assert_array_equal(sd["pre.0.weight"].numpy(), np.asarray(params["pre"][0]["w"]).T)
    np.testing.assert_array_equal(sd["q"].numpy(), np.asarray(params["q"]))
    assert "B" not in dict(tm.named_parameters())  # a buffer, as stop_gradient'd in JAX
    tm(torch.rand(3, 3)).sum().backward()
    grads = grads_to_jax_layout(tm)
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))
    for a, b in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape


@pytest.mark.parametrize("engine", [None, "block_kernel"])
def test_streams_residual_parity(engine):
    jm, params, tm = _models(4, 10, mapping=4)
    if engine is not None:
        tm.use_fused(engine)
    X = np.random.default_rng(0).uniform(0.1, 0.9, size=(8, 3)).astype(np.float32)
    u_j, r_j = jax.jit(lambda p, Xp: j_streams(jm, p, Xp))(params, jnp.asarray(X))
    u_t, r_t = t_streams(tm, torch.as_tensor(X))
    np.testing.assert_allclose(u_t.detach().numpy(), np.asarray(u_j), atol=2e-5)
    np.testing.assert_allclose(
        r_t.detach().numpy(), np.asarray(r_j), rtol=5e-3, atol=5e-4)
