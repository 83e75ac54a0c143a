"""The port's Czochralski model (qcpinn_tpu_torch/models/czochralski.py)
against the JAX package's on the same numpy inputs and bridged weights:
the data-reuploading circuit (exact, with the parameter-shift offsets,
under noise), the Hybrid16QPINN forward, its hard axis constraints, its
parameter counts, remat, and the bridge both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.models import czochralski as jcz
from qcpinn_tpu.models.nn_core import count_trainable as j_count_trainable
from qcpinn_tpu.ops import NoiseModel as JNoise
from qcpinn_tpu_torch.bridge import params_from_jax, params_to_jax
from qcpinn_tpu_torch.models import czochralski as tcz
from qcpinn_tpu_torch.models.nn_core import count_trainable, layernorm_apply, layernorm_init
from qcpinn_tpu_torch.ops import NoiseModel


def _circuit_inputs(n, L, b=5, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 2 * np.pi, (L, n, 3)).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, (b, n)).astype(np.float32)
    enc = rng.uniform(-1, 1, (n,)).astype(np.float32)
    reup = rng.uniform(-1, 1, (L, n)).astype(np.float32)
    return w, x, enc, reup


@pytest.mark.parametrize("offsets", [False, True])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("n", [3, 4, 5])
def test_circuit_matches_jax(n, noisy, offsets):
    """Exact <Z> at n = 3, 4, 5 (a short last wire group at 5), L = 2,
    atol 1e-5; with the encoding and reupload offsets; under the
    depolarizing, readout and depth-aware per-gate channel."""
    L = 2
    w, x, enc, reup = _circuit_inputs(n, L)
    kw = {"enc_off": enc, "reup_off": reup} if offsets else {}
    noise = NoiseModel(0.05, 0.02, 0.01) if noisy else None
    jnoise = JNoise(0.05, 0.02, 0.01) if noisy else None
    got = tcz.CzQuantumLayer(n, L).apply(
        torch.tensor(w), torch.tensor(x), noise=noise,
        **{k: torch.tensor(v) for k, v in kw.items()})
    want = jax.jit(lambda *a: jcz.CzQuantumLayer(n, L).apply(
        a[0], a[1], noise=jnoise, **dict(zip(kw, a[2:]))))(
        jnp.asarray(w), jnp.asarray(x), *(jnp.asarray(v) for v in kw.values()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n,L", [(3, 1), (4, 2), (16, 2), (16, 3)])
def test_gate_counts_and_brickwork_match_jax(n, L):
    assert tcz.CzQuantumLayer(n, L).gate_counts_per_wire() == \
        jcz.CzQuantumLayer(n, L).gate_counts_per_wire()
    np.testing.assert_array_equal(tcz._cz_brickwork_phases(n), jcz._cz_brickwork_phases(n))
    assert tcz._wire_groups(n) == jcz._wire_groups(n)


def test_sampled_circuit_needs_a_key_and_follows_the_law():
    n, L = 3, 1
    w, x, _, _ = _circuit_inputs(n, L, b=4)
    q = tcz.CzQuantumLayer(n, L)
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        q.apply(torch.tensor(w), torch.tensor(x), shots=64)
    exact = q.apply(torch.tensor(w), torch.tensor(x))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([q.apply(torch.tensor(w), torch.tensor(x), shots=256, key=gen)
                         for _ in range(200)])
    # the binomial estimator: mean <Z>, variance (1 - <Z>^2) / shots
    se = torch.sqrt((1 - exact**2) / 256 / 200)
    assert float(((draws.mean(0) - exact).abs() / (se + 1e-6)).max()) < 5.0


def _models(n=4, width=16, L=2, remat=False, seed=1):
    jm = jcz.Hybrid16QPINN(n_qubits=n, n_layers=L, width=width, remat=remat)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = tcz.Hybrid16QPINN(n, L, width=width, remat=remat, device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    return jm, tree, tm


def test_hybrid_matches_jax_and_bridges_back():
    jm, tree, tm = _models()
    x = np.random.default_rng(0).uniform(0, 1, (9, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(), want, atol=1e-5)
    feats = np.asarray(jax.jit(jm.quantum_features)(tree, jnp.asarray(x)))
    np.testing.assert_allclose(tm.quantum_features(torch.tensor(x)).detach().numpy(), feats,
                               atol=1e-5)
    back = params_to_jax(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_hybrid_hard_constraints():
    _, _, tm = _models()
    x = torch.rand(6, 2, generator=torch.Generator().manual_seed(0))
    x[:, 0] = 0.0  # on the symmetry axis r = 0
    out = tm(x)
    assert torch.all(out[:, 0] == 0) and torch.all(out[:, 2] == 0)
    assert torch.all(out[:, [1, 3, 4]] != 0)


def test_param_counts_match_jax_and_the_reference():
    """125,973 trainable at the flagship's size (2 layers), 126,021 at 3
    (JAX's tests/test_czochralski.py:127-140); the Fourier matrix is a
    buffer."""
    for L, want in ((2, 125_973), (3, 126_021)):
        tm = tcz.Hybrid16QPINN(16, L, device="cpu")
        assert count_trainable(tm) == want
        jp = jcz.Hybrid16QPINN(16, L).init(jax.random.PRNGKey(0))
        assert j_count_trainable(jp) == want
        assert "B" in dict(tm.named_buffers())


def test_remat_gives_the_same_gradients():
    """remat (checkpointed segments) against none in reverse mode, and under
    the forward-mode residual's jvp (where the segments run unwrapped)."""
    from qcpinn_tpu_torch.physics.operators_fwd import cz_residuals_fwd

    _, tree, plain = _models(remat=False)
    remat = tcz.Hybrid16QPINN(4, 2, width=16, remat=True, device="cpu")
    remat.load_state_dict(params_from_jax(tree))
    x = torch.rand(7, 2, generator=torch.Generator().manual_seed(0))
    for loss in (lambda m: torch.sum(m(x) ** 2),
                 lambda m: cz_residuals_fwd(m, x, 3.0, 15.0, 28.0, 80.0)[0]):
        g1 = torch.autograd.grad(loss(plain), list(plain.parameters()))
        g2 = torch.autograd.grad(loss(remat), list(remat.parameters()))
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_init_is_seeded_and_in_place():
    a = tcz.Hybrid16QPINN(4, 1, width=8, seed=3, device="cpu")
    b = tcz.Hybrid16QPINN(4, 1, width=8, seed=4, device="cpu")
    q = a.q
    a.init(4)
    assert a.q is q
    for (k, t), (_, u) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(t, u), k
    assert float(a.q.detach().min()) >= 0 and float(a.q.detach().max()) < 2 * np.pi


def test_head_filter_and_sharding_refusal():
    tm = tcz.Hybrid16QPINN(3, 1, width=8, device="cpu")
    mask = tcz.Hybrid16QPINN.head_param_filter(tm)
    assert set(mask) == {k for k, _ in tm.named_parameters()}
    assert {k for k, v in mask.items() if v} == {k for k, _ in tm.named_parameters()
                                                  if k.startswith("post.")}
    with pytest.raises(NotImplementedError, match="parallel"):
        tm.use_sharded(None)


def test_layernorm_matches_jax():
    from qcpinn_tpu.models import nn_core as jnc

    x = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    p = layernorm_init(16)
    with torch.no_grad():
        p["gamma"].mul_(1.5)
        p["beta"].add_(0.25)
    jp = {"gamma": jnp.full((16,), 1.5), "beta": jnp.full((16,), 0.25)}
    np.testing.assert_allclose(layernorm_apply(p, torch.tensor(x)).detach().numpy(),
                               np.asarray(jnc.layernorm_apply(jp, jnp.asarray(x))), atol=1e-6)
