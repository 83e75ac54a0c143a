"""The port's block engine over an amplitude-sharded state
(qcpinn_tpu_torch/parallel/sharded_block.py: all-to-alls around the
high-block products) on a gloo world of 8 CPU processes against the JAX
package's GSPMD-sharded block engine on the conftest's 8-device mesh, at
JAX's limits (tests/test_sharded_block.py): 5e-5 forward and evolve, 2e-4 x
max|ref| on gradients, the shots and noise surface, the ``hi_bits`` checks.
One world runs every case (``torch_parallel_worker.sharded_cases``)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models import DVSolver as JDV
from qcpinn_tpu.ops import DVCircuit as JCircuit
from qcpinn_tpu.ops.measure import NoiseModel as JNoise
from qcpinn_tpu.parallel import make_mesh as j_make_mesh
from qcpinn_tpu.parallel.sharded_block import ShardedBlockCircuit as JBlock
from qcpinn_tpu.physics.streams import dv_diffusion_residual_streams as j_streams
from qcpinn_tpu_torch.ops import DVCircuit, NoiseModel
from qcpinn_tpu_torch.parallel.sharded_block import ShardedBlockCircuit
from torch_parallel_worker import sharded_cases, start_world

STREAMS_CFG = dict(num_qubits=5, num_quantum_layers=1, q_ansatz="cross_mesh",
                   classic_network=(3, 12, 1), seed=7)


def _case(n, ansatz, layers, data, amp, seed=None, batch=8, encoding="angle", feats=None,
          want=("z",), **kw):
    circ = DVCircuit(n, layers, ansatz, seed=seed, encoding=encoding)
    rng = np.random.default_rng(1)
    params = (rng.normal(size=(layers, circ.params_per_layer))
              * np.sqrt(2.0 / (layers + circ.params_per_layer))).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, (batch, feats or n)).astype(np.float32)
    return dict(n=n, ansatz=ansatz, layers=layers, data=data, amp=amp, seed=seed,
                encoding=encoding, params=params, x=x, want=want, **kw)


def cases():
    c = {a: _case(5, a, 1, 2, 4) for a in ("cascade", "cross_mesh", "sim_circ_15")}
    c["cascade"]["want"] = ("z", "grad")
    c["haar_two_layers_amp8"] = _case(5, "layered", 2, 1, 8, seed=11)
    c["evolve"] = _case(6, "cross_mesh", 1, 2, 4, seed=3, want=("evolve",))
    c["amplitude"] = _case(4, "cascade", 1, 2, 4, encoding="amplitude", feats=10)
    c["shots_noise"] = _case(4, "cascade", 1, 2, 4, want=("z", "noise"), noise=(0.1, 0.02),
                             shots=8192)
    return c


@pytest.fixture(scope="module")
def world():
    jm = JDV(JConfig(**STREAMS_CFG))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    X = np.random.default_rng(2).uniform(size=(8, 3)).astype(np.float32)
    payload = {"backend": "block", "circuits": cases(),
               "streams": dict(cfg=STREAMS_CFG, params=params, X=X, data=2, amp=4)}
    future = start_world(8, sharded_cases, payload)
    # JAX's forwards while the world runs
    refs = {}
    for tag, c in payload["circuits"].items():
        if "z" in c["want"]:
            _, sb = _jax(c)
            refs[tag] = np.asarray(jax.jit(sb.apply)(c["params"], c["x"]))
    return payload, refs, future.result()


def _jax(c):
    jc = JCircuit(c["n"], c["layers"], c["ansatz"], seed=c["seed"], encoding=c["encoding"])
    return jc, JBlock(jc, j_make_mesh(data=c["data"], amp=c["amp"]))


@pytest.mark.parametrize("tag", ["cascade", "cross_mesh", "sim_circ_15",
                                 "haar_two_layers_amp8", "amplitude"])
def test_forward_parity(world, tag):
    _, refs, res = world
    want = refs[tag]
    for r in res:
        np.testing.assert_allclose(r[f"{tag}/z"], want, atol=5e-5)


def test_evolve_matches_jax(world):
    payload, _, res = world
    c = payload["circuits"]["evolve"]
    jc, sb = _jax(c)
    want = np.asarray(jax.jit(sb.evolve)(c["params"], jax.jit(jc.prepare)(c["x"])))
    np.testing.assert_allclose(res[0]["evolve/evolve"], want, atol=5e-5)


def test_gradient_parity(world):
    payload, _, res = world
    c = payload["circuits"]["cascade"]
    _, sb = _jax(c)
    want = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(sb.apply(p, c["x"]) ** 2)))(
        c["params"]))
    for r in res:
        np.testing.assert_allclose(r["cascade/grad"], want, atol=2e-4 * np.abs(want).max())


def test_shots_and_noise_supported_sharded(world):
    """Exact noise scales by the analytic depolarizing/readout factor (and
    matches JAX's); the sampled readout concentrates around the exact value
    and is the unsharded engine's draw for the same generator and rows."""
    payload, _, res = world
    c = payload["circuits"]["shots_noise"]
    _, sb = _jax(c)
    want = np.asarray(jax.jit(lambda p, x: sb.apply(p, x, noise=JNoise(*c["noise"])))(
        c["params"], c["x"]))
    exact = res[0]["shots_noise/z"]
    np.testing.assert_allclose(res[0]["shots_noise/noisy"], want, atol=5e-5)
    np.testing.assert_allclose(res[0]["shots_noise/noisy"], exact * 0.9 * 0.96, atol=1e-5)
    circ = DVCircuit(c["n"], c["layers"], c["ansatz"], seed=c["seed"])
    for r in res:
        plain = circ.apply(torch.tensor(c["params"]), torch.tensor(r["shots_noise/rows"]),
                           shots=c["shots"], key=torch.Generator().manual_seed(7),
                           noise=NoiseModel(*c["noise"]))
        np.testing.assert_array_equal(r["shots_noise/shots"], plain.numpy())
        assert np.all(np.isfinite(r["shots_noise/shots"]))


def _fake_mesh(amp):
    return types.SimpleNamespace(axis=lambda name: types.SimpleNamespace(size=amp))


def test_hi_bits_must_cover_amp_axis():
    with pytest.raises(ValueError, match="amp axis"):
        ShardedBlockCircuit(DVCircuit(4, 1, "cascade"), _fake_mesh(8), hi_bits=2)
    # an amp axis as large as the whole state leaves no low block: the
    # constructor explains the remedy itself
    with pytest.raises(ValueError, match="fewer amp devices"):
        ShardedBlockCircuit(DVCircuit(3, 1, "cascade"), _fake_mesh(8))
    with pytest.raises(ValueError, match="power of 2"):
        ShardedBlockCircuit(DVCircuit(4, 1, "cascade"), _fake_mesh(3))


def test_streams_compose_with_sharded_block_backend(world):
    payload, _, res = world
    c = payload["streams"]
    jm = JDV(JConfig(**STREAMS_CFG)).use_sharded(j_make_mesh(data=2, amp=4), backend="block")
    u, r = jax.jit(lambda p, X: j_streams(jm, p, X))(c["params"], c["X"])
    np.testing.assert_allclose(res[0]["streams/u"], np.asarray(u), atol=2e-6)
    np.testing.assert_allclose(res[0]["streams/r"], np.asarray(r), atol=2e-6)
    g = jax.jit(jax.grad(lambda p: jnp.sum(j_streams(jm, p, c["X"])[1] ** 2)))(c["params"])
    got, want = jax.tree_util.tree_leaves(res[0]["streams/grads"]), jax.tree_util.tree_leaves(g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=2e-4 * max(np.abs(b).max(), 1e-6))
