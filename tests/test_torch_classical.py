"""The port's Hopfield baseline (models/classical_solver.py) and parameter
counts against the JAX package: forward and grads on weights carried over
by the bridge, the batch coupling, the bridge both ways, and the trainable
counts of the JAX records (717 and 7,751)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models import ClassicalSolver as JClassical
from qcpinn_tpu.models import DVSolver as JDV
from qcpinn_tpu.models import nn_core as jnc
from qcpinn_tpu.models.dv_fourier import DVFourierSolver as JFourier
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax, params_to_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.models import ClassicalSolver as TClassical
from qcpinn_tpu_torch.models import DVFourierSolver as TFourier
from qcpinn_tpu_torch.models import DVSolver as TDV
from qcpinn_tpu_torch.models import nn_core as tnc


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _classical(net=(3, 8, 1), seed=0):
    jm = JClassical(JConfig(solver="Classical", classic_network=net))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = TClassical(TConfig(solver="Classical", classic_network=net), device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, tm


def _assert_tree_close(got, want, rtol=2e-4):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np(want))
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        scale = max(float(np.max(np.abs(np.asarray(w)))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(w), atol=rtol * scale)


@pytest.mark.parametrize("net", [(3, 8, 1), (2, 6, 3)])
def test_forward_and_grads_match_jax(net):
    jm, params, tm = _classical(net)
    x = np.random.default_rng(1).uniform(size=(7, net[0])).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    got = tm(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    g_ref = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2))(params)
    torch.sum(tm(torch.tensor(x)) ** 2).backward()
    _assert_tree_close(grads_to_jax_layout(tm), g_ref)


def test_bridge_round_trips_the_hopfield_tree():
    _, params, tm = _classical()
    back = params_to_jax(tm)
    assert set(back["hopfield"]) == {"w_q", "w_k", "w_v"}
    assert all(set(layer) == {"w"} for layer in back["hopfield"].values())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(_np(params))
    for a, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(w))


def test_batch_coupling():
    """One changed row moves every row's output (the B x B attention), as in
    JAX; a point-decoupled DV model moves only that row."""
    jm, params, tm = _classical()
    x = np.random.default_rng(2).uniform(size=(6, 3)).astype(np.float32)
    x2 = x.copy()
    x2[4] += 0.3
    a, b = tm(torch.tensor(x)).detach(), tm(torch.tensor(x2)).detach()
    assert bool((a - b).abs()[:4].min() > 0) and TClassical.batch_coupled
    ja, jb = jm.apply(params, jnp.asarray(x)), jm.apply(params, jnp.asarray(x2))
    np.testing.assert_allclose((b - a).numpy(), np.asarray(jb - ja), atol=2e-5)
    dv = TDV(TConfig(num_qubits=2, classic_network=(3, 4, 1)), device="cpu")
    da, db = dv(torch.tensor(x)).detach(), dv(torch.tensor(x2)).detach()
    assert torch.equal(torch.cat([da[:4], da[5:]]), torch.cat([db[:4], db[5:]]))
    assert not getattr(dv, "batch_coupled", False)


def test_trainable_counts_of_the_jax_records():
    """717 (DV cascade, 4 qubits, hidden 50) and 7,751 (Hopfield at (3, 50,
    1)), the counts artifacts/dv_diffusion_cli_baseline.json and
    artifacts/classical_diffusion_reference_recipe.json record."""
    dv_cfg = dict(num_qubits=4, q_ansatz="cascade", classic_network=(3, 50, 1))
    dv = TDV(TConfig(**dv_cfg), device="cpu")
    assert tnc.count_trainable(dv) == 717 == tnc.count_params(dv)
    assert jnc.count_trainable(JDV(JConfig(**dv_cfg)).init(jax.random.PRNGKey(0))) == 717
    hop = TClassical(TConfig(solver="Classical"), device="cpu")
    assert tnc.count_trainable(hop) == 7751
    assert jnc.count_trainable(JClassical(JConfig(solver="Classical")).init(
        jax.random.PRNGKey(0))) == 7751


def test_fourier_map_is_not_trainable():
    kw = dict(num_qubits=3, classic_network=(3, 8, 1), q_ansatz="cross_mesh")
    tm = TFourier(TConfig(**kw), mapping_size=4, skip_dim=4, device="cpu")
    params = JFourier(JConfig(**kw), mapping_size=4, skip_dim=4).init(jax.random.PRNGKey(0))
    assert tnc.count_trainable(tm) == jnc.count_trainable(params)
    assert tnc.count_params(tm) == jnc.count_params(params)
    assert tnc.count_params(tm) - tnc.count_trainable(tm) == tm.B.numel() == 12


def test_init_is_xavier_with_bias_free_projections():
    tm = TClassical(TConfig(solver="Classical", classic_network=(3, 40, 1)), device="cpu")
    for layer in tm.hopfield.values():
        assert layer.bias is None
        np.testing.assert_allclose(float(layer.weight.detach().std()), np.sqrt(2.0 / 80), rtol=0.1)
    assert not tm.pre.bias.any() and not tm.post.bias.any()
    again = TClassical(TConfig(solver="Classical", classic_network=(3, 40, 1)), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), again.parameters()))
