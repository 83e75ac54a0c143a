"""The port's SI-gated pieces (qcpinn_tpu_torch/models/si_gated.py) against
the JAX package's on the same numpy inputs and the same weights, carried
across by the bridge: the SI-gated head and ``SIChainCircuit`` with the
exact readout (forward atol 2e-5, grads within 2e-4 x max|ref| of each
leaf), the chain's gate counts and depth-aware noise, its sampled readout
by the binomial law, and the head and chain weights through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from qcpinn_tpu.models import si_gated as js
from qcpinn_tpu.ops.measure import NoiseModel as JNoise
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax, params_to_jax
from qcpinn_tpu_torch.models import si_gated as ts
from qcpinn_tpu_torch.ops.measure import NoiseModel


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_leaves(got, want, rtol=2e-4):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, w, rtol=0, atol=rtol * np.abs(w).max())


def test_head_matches_jax():
    """The head's forward and every gradient, and its tree both ways."""
    params = _np(js.si_gated_head_init(jax.random.PRNGKey(0), 4, 16, 5))
    head = ts.si_gated_head_init(4, 16, 5)
    assert {k: tuple(p.shape) for k, p in head.named_parameters()} == {
        f"{k}.{n}": tuple(np.shape(params[k][{"weight": "w", "bias": "b"}[n]])[::-1])
        for k in params for n in ("weight", "bias")}
    head.load_state_dict(params_from_jax(params))
    q = np.random.default_rng(0).uniform(-1, 1, (6, 4)).astype(np.float32)
    want = np.asarray(js.si_gated_head_apply(params, jnp.asarray(q)))
    out = ts.si_gated_head_apply(head, torch.tensor(q))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5)
    (out**2).sum().backward()
    g = _np(jax.grad(lambda p: jnp.sum(js.si_gated_head_apply(p, jnp.asarray(q)) ** 2))(params))
    _close_leaves(grads_to_jax_layout(head), g)
    back = params_to_jax(head)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,layers", [(4, 1), (5, 2), (3, 2)])
def test_chain_matches_jax(n, layers):
    """RY(x[i % 4]) re-uploads, RX/RZ sweeps (layer-major, qubit-minor, RX
    then RZ), the open CZ chain, <Z_i>: forward atol 2e-5, the gradients of
    sum(out^2) in the weights and the inputs within 2e-4 x max|ref|."""
    jc, tc = js.SIChainCircuit(n, layers), ts.SIChainCircuit(n, layers)
    assert tc.num_params == jc.num_params == 2 * n * layers
    assert tc.gate_counts_per_wire() == jc.gate_counts_per_wire()
    w = 0.7 * np.random.default_rng(n).standard_normal(tc.num_params).astype(np.float32)
    x = np.random.default_rng(layers).uniform(-np.pi, np.pi, (3, 4)).astype(np.float32)

    def loss(w, x):
        return jnp.sum(jc.apply(w, x) ** 2)

    want = np.asarray(jax.jit(jc.apply)(w, x))
    gw, gx = (np.asarray(a) for a in jax.jit(jax.grad(loss, argnums=(0, 1)))(w, x))
    tw, tx = torch.tensor(w, requires_grad=True), torch.tensor(x, requires_grad=True)
    out = tc(tw, tx)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5)
    (out**2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), gw, atol=2e-4 * np.abs(gw).max())
    np.testing.assert_allclose(tx.grad.numpy(), gx, atol=2e-4 * np.abs(gx).max())
    np.testing.assert_allclose(tc.cz_phases(), np.exp(1j * np.pi * np.asarray(
        [sum(((s >> (n - 1 - i)) & 1) * ((s >> (n - 2 - i)) & 1) for i in range(n - 1))
         for s in range(1 << n)])), atol=1e-6)


def test_chain_noise_and_init():
    """The depth-aware channel damps <Z_w> by (1 - p)^(count on w), as
    JAX's; the counts grow with the layers; the init is 0.01 N(0, 1)."""
    tc = ts.SIChainCircuit(4, 2)
    np.testing.assert_array_equal(np.asarray(ts.SIChainCircuit(5, 3).gate_counts_per_wire()),
                                  3 * np.asarray(ts.SIChainCircuit(5, 1).gate_counts_per_wire()))
    w = tc.init(torch.Generator().manual_seed(1))
    assert w.shape == (16,) and float(w.abs().max()) < 0.05
    x = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (2, 4)).astype(np.float32))
    clean = tc(w, x)
    noisy = tc(w, x, noise=NoiseModel(per_gate=0.01))
    counts = torch.tensor(tc.gate_counts_per_wire(), dtype=torch.float32)
    torch.testing.assert_close(noisy, clean * 0.99**counts, rtol=1e-6, atol=1e-7)
    jc = js.SIChainCircuit(4, 2)
    want = np.asarray(jax.jit(lambda w, x: jc.apply(w, x, noise=JNoise(per_gate=0.01)))(
        w.numpy(), x.numpy()))
    np.testing.assert_allclose(noisy.numpy(), want, atol=2e-5)


def test_chain_sampled_readout_follows_the_binomial_law():
    """64 draws at S = 1024 of every <Z_i>: each mean within 4 sigma /
    sqrt(64), the pooled variance within 25% of (1 - <Z>^2) / S; no
    gradient; a key is required."""
    tc = ts.SIChainCircuit(4, 2)
    w = 0.5 * torch.randn(tc.num_params, generator=torch.Generator().manual_seed(3))
    x = torch.tensor(np.random.default_rng(4).uniform(-1, 1, (5, 4)).astype(np.float32))
    z = tc(w, x)
    gen = torch.Generator().manual_seed(5)
    draws = torch.stack([tc(w, x, shots=1024, key=gen) for _ in range(64)])
    sigma2 = (1.0 - z**2) / 1024
    assert float(((draws.mean(0) - z).abs() / (4.0 * torch.sqrt(sigma2) / 8.0)).max()) <= 1.0
    assert abs(float((draws.var(0) / sigma2).mean()) - 1.0) <= 0.25
    assert not draws.requires_grad
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        tc(w, x, shots=16)


class _SIModel(nn.Module):
    """A model that holds the chain's weights as ``q`` and the SI head."""

    def __init__(self):
        super().__init__()
        self.q = nn.Parameter(ts.SIChainCircuit(4, 2).init())
        for k, layer in ts.si_gated_head_init(4, 8, 1).items():
            setattr(self, k, layer)


def test_head_and_chain_weights_cross_the_bridge():
    tree = {"q": np.arange(16, dtype=np.float32),
            **_np(js.si_gated_head_init(jax.random.PRNGKey(2), 4, 8, 1))}
    model = _SIModel()
    model.load_state_dict(params_from_jax(tree))
    back = params_to_jax(model)
    assert sorted(back) == sorted(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
