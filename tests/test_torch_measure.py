"""The port's readout modes (qcpinn_tpu_torch/ops/measure.py and every
engine's ``apply(..., shots, key, noise)``) against the JAX package's
ops/measure.py: the per-wire gate counts of the depth-aware channel, the
noisy readouts (exact_z, exact_global_z, DVCircuit and each engine's plain
version, a noisy DVSolver's forward and backprop), and the law of the shot
sampler. Shots compare by law, not draw for draw: torch generators do not
replay jax.random."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models import DVSolver as JSolver
from qcpinn_tpu.ops import DVCircuit as JCircuit
from qcpinn_tpu.ops import ansatz as jansatz
from qcpinn_tpu.ops import measure as jmeasure
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.models import DVSolver as TSolver
from qcpinn_tpu_torch.ops import BlockFusedCircuit, BlockKernelCircuit, FusedCircuit
from qcpinn_tpu_torch.ops import LoopFusedCircuit, NoiseModel
from qcpinn_tpu_torch.ops import ansatz as tansatz
from qcpinn_tpu_torch.ops import measure
from qcpinn_tpu_torch.ops.circuit import DVCircuit

ANSATZE = sorted(tansatz.BUILDERS)
NOISES = {
    "depolarizing": dict(depolarizing=0.1),
    "readout": dict(readout=0.03),
    "per_gate": dict(per_gate=0.01),
    "all": dict(depolarizing=0.05, readout=0.02, per_gate=0.01),
}
# each engine's forward limit (the JAX tests' own: block chain 2e-5, gate
# loop 5e-6, unrolled 3e-5; the gate-by-gate circuit and plain block 2e-5)
ENGINES = {"circuit": (None, 2e-5), "block": (BlockFusedCircuit, 2e-5),
           "block_kernel": (BlockKernelCircuit, 2e-5), "loop": (LoopFusedCircuit, 5e-6),
           "unrolled": (FusedCircuit, 3e-5)}


def _pair(n, layers, ansatz, seed=None):
    return JCircuit(n, layers, ansatz, seed=seed), DVCircuit(n, layers, ansatz, seed=seed)


@pytest.mark.parametrize("ansatz", [*ANSATZE, "reupload_cz_brickwork"])
def test_gate_counts_match_jax(ansatz):
    for n in (3, 4):
        for layers in (1, 3):
            if ansatz == "reupload_cz_brickwork":
                # the Czochralski layer's program, counted as a DVCircuit is
                def duck(mod):
                    return types.SimpleNamespace(
                        n=n, layers=layers, epilogue=(),
                        program_raw=mod.reupload_cz_brickwork(n, 0))

                jc, tc = duck(jansatz), duck(tansatz)
            else:
                jc, tc = _pair(n, layers, ansatz, seed=5)
            got = measure.gate_counts_per_wire(tc)
            assert got == jmeasure.gate_counts_per_wire(jc), (n, layers)
            assert len(got) == n and all(isinstance(c, int) for c in got)


@functools.lru_cache(maxsize=None)
def _state(n=4, b=5, ansatz="cross_mesh"):
    """(JAX circuit, port circuit, params, inputs, final state): built once
    a shape, the state by JAX's gate-by-gate engine."""
    jc, tc = _pair(n, 2, ansatz, seed=3)
    params = jc.init_params(jax.random.PRNGKey(1))
    x = np.random.default_rng(2).uniform(-1, 1, (b, n)).astype(np.float32)
    st = np.asarray(jax.jit(jc.state)(params, jnp.asarray(x)))
    return jc, tc, params, x, st


@pytest.mark.parametrize("kind", list(NOISES))
def test_noisy_readouts_match_jax(kind):
    jc, tc, _, _, st = _state()
    jn = jmeasure.NoiseModel(**NOISES[kind]).bind(jc)
    tn = NoiseModel(**NOISES[kind]).bind(tc)
    assert tn.gate_counts == jn.gate_counts
    ts = torch.tensor(st)
    np.testing.assert_allclose(measure.exact_z(ts, 4, tn).numpy(),
                               np.asarray(jmeasure.exact_z(jnp.asarray(st), 4, jn)), atol=1e-6)
    np.testing.assert_allclose(measure.exact_global_z(ts, 4, tn).numpy(),
                               np.asarray(jmeasure.exact_global_z(jnp.asarray(st), 4, jn)),
                               atol=1e-6)
    np.testing.assert_allclose(tn.wire_scales(4).numpy(), np.asarray(jn.wire_scales(4)),
                               atol=1e-7)
    # one device constant a channel, width and device
    assert tn.wire_scales(4) is tn.wire_scales(4, "cpu")


def test_unbound_per_gate_noise_raises():
    with pytest.raises(ValueError, match="gate counts"):
        NoiseModel(per_gate=0.02).apply(torch.ones(2, 3))
    legacy = NoiseModel(depolarizing=0.1, readout=0.02)
    assert legacy.bind(DVCircuit(3)) is legacy
    np.testing.assert_allclose(legacy.apply(torch.ones(2, 3)).numpy(), 0.9 * 0.96, atol=1e-7)


@functools.lru_cache(maxsize=None)
def _noisy_jax(n, b):
    jc, _, params, x, _ = _state(n=n, b=b)
    noise = jmeasure.NoiseModel(**NOISES["all"])
    return np.asarray(jax.jit(lambda p, xx: jc.apply(p, xx, noise=noise))(params, jnp.asarray(x)))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_noisy_forward_match_jax(engine):
    """Each engine's apply (its kernels' plain versions on the CPU) binds
    the channel to its circuit; held to JAX's gate-by-gate circuit."""
    cls, tol = ENGINES[engine]
    jc, tc, params, x, _ = _state(n=4, b=6)
    noise = NOISES["all"]
    want = _noisy_jax(n=4, b=6)
    eng = tc if cls is None else cls(tc)
    p = torch.tensor(np.asarray(params))
    if cls is not None:
        p = p.reshape(-1)
    got = eng.apply(p, torch.tensor(x), noise=NoiseModel(**noise))
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        eng.apply(p, torch.tensor(x), shots=16)
    # the sampled readout: S * (1 - z) / 2 whole counts, no gradient
    pg = p.clone().requires_grad_(True)
    s = eng.apply(pg, torch.tensor(x), shots=64, key=torch.Generator().manual_seed(0),
                  noise=NoiseModel(**noise))
    counts = (1.0 - s) * 32.0
    assert not s.requires_grad and s.shape == (6, 4)
    np.testing.assert_allclose(counts.numpy(), np.round(counts.numpy()), atol=1e-4)


def test_noisy_model_backprop_matches_jax():
    kw = dict(num_qubits=2, classic_network=(3, 8, 1), q_ansatz="cascade", seed=4,
              noise_depolarizing=0.05, noise_readout=0.02, noise_per_gate=0.01)
    jm = JSolver(JConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0))
    tm = TSolver(TConfig(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert tm.noise.gate_counts == jm.noise.bind(jm.circuit).gate_counts
    x = np.random.default_rng(3).uniform(size=(7, 3)).astype(np.float32)
    want, g = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2)))(params)
    out = tm(torch.tensor(x))
    torch.sum(out**2).backward()
    np.testing.assert_allclose(float(torch.sum(out.detach() ** 2)), float(want), rtol=1e-5)
    got = grads_to_jax_layout(tm)
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(g)):
        np.testing.assert_allclose(a, np.asarray(w), atol=2e-4 * float(jnp.max(jnp.abs(w))))
    # the sampled forward carries no gradient into the circuit
    s = tm(torch.tensor(x), shots=128, key=torch.Generator().manual_seed(1))
    assert s.shape == (7, 1) and torch.isfinite(s).all()


def _law(draws, z, shots):
    """(worst |mean - z| / (4 sigma / sqrt(D)), pooled var / sigma^2) over
    D draws of each element."""
    d = draws.shape[0]
    sigma2 = (1.0 - z**2) / shots
    mean_err = (draws.mean(0) - z).abs() / (4.0 * torch.sqrt(sigma2) / d**0.5)
    var_ratio = (draws.var(0) / sigma2).mean()
    return float(mean_err.max()), float(var_ratio)


def test_sampled_z_follows_the_binomial_law():
    """64 seeded draws at S = 1024 of every <Z_w>: each mean within
    4 sigma / sqrt(64) of the exact value, sigma^2 = (1 - <Z>^2) / S, and the
    variance, pooled over the elements, within 25% of sigma^2."""
    _, tc, params, x, st = _state(n=4, b=5)
    ts = torch.tensor(st)
    z = measure.exact_z(ts, 4)
    assert float(z.abs().max()) < 0.95
    gen = torch.Generator().manual_seed(11)
    draws = torch.stack([measure.sampled_z(ts, 4, 1024, gen) for _ in range(64)])
    worst, ratio = _law(draws, z, 1024)
    assert worst <= 1.0 and abs(ratio - 1.0) <= 0.25, (worst, ratio)
    # one draw of shape [64, B, n] has the same law
    worst, ratio = _law(measure.sample_z_from_expectations(z.expand(64, -1, -1), 1024, gen),
                        z, 1024)
    assert worst <= 1.0 and abs(ratio - 1.0) <= 0.25, (worst, ratio)
    zg = measure.exact_global_z(ts, 4)
    dg = torch.stack([measure.sampled_global_z(ts, 4, 1024, gen) for _ in range(64)])
    worst, ratio = _law(dg, zg, 1024)
    assert worst <= 1.0 and abs(ratio - 1.0) <= 0.25, (worst, ratio)
    # no gradient, and a generator is required
    tg = ts.clone().requires_grad_(True)
    assert not measure.sampled_z(tg, 4, 16, gen).requires_grad
    p = torch.tensor(np.asarray(params))
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        tc.apply(p, torch.tensor(x), shots=16)
    # the same generator state gives the same draw
    a = measure.sampled_z(ts, 4, 256, torch.Generator().manual_seed(5))
    b = measure.sampled_z(ts, 4, 256, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
