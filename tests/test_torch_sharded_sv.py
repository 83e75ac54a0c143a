"""The port's amplitude-sharded per-gate engine
(qcpinn_tpu_torch/parallel/sharded_sv.py) on a gloo world of 8 CPU
processes against the JAX package's sharded engine on the conftest's
8-device mesh, at JAX's own limits (tests/test_sharded_sv.py): 5e-5 on the
forward and the evolve, 2e-4 x max|ref| on gradients. One world runs every
case of this file (``torch_parallel_worker.sharded_cases``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models import DVSolver as JDV
from qcpinn_tpu.ops import DVCircuit as JCircuit
from qcpinn_tpu.parallel import make_mesh as j_make_mesh
from qcpinn_tpu.parallel.sharded_sv import ShardedCircuit as JSharded
from qcpinn_tpu.parallel.sharded_sv import make_sharded_circuit_apply as j_sharded_apply
from qcpinn_tpu.physics.streams import dv_diffusion_residual_streams as j_streams
from qcpinn_tpu_torch.ops import DVCircuit, NoiseModel
from torch_parallel_worker import sharded_cases, start_world

ANSATZE = ("layered", "alternate", "farhi", "sim_circ_15", "cross_mesh")
STREAMS_CFG = dict(num_qubits=5, num_quantum_layers=1, q_ansatz="cross_mesh",
                   classic_network=(3, 12, 1), seed=7)


def _case(n, ansatz, layers, data, amp, seed=None, batch=8, encoding="angle", feats=None,
          want=("z",), **kw):
    circ = DVCircuit(n, layers, ansatz, seed=seed, encoding=encoding)
    rng = np.random.default_rng(1)
    params = (rng.normal(size=(layers, circ.params_per_layer))
              * np.sqrt(2.0 / (layers + circ.params_per_layer))).astype(np.float32)
    if encoding == "amplitude":
        x = rng.normal(size=(batch, feats)).astype(np.float32)
    else:
        x = rng.uniform(-np.pi, np.pi, (batch, feats or n)).astype(np.float32)
    return dict(n=n, ansatz=ansatz, layers=layers, data=data, amp=amp, seed=seed,
                encoding=encoding, params=params, x=x, want=want, **kw)


def cases():
    c = {f"cascade_amp{a}": _case(4, "cascade", 1, 8 // a, a) for a in (2, 4, 8)}
    c.update({f"{a}_amp4": _case(5, a, 1, 2, 4) for a in ANSATZE})
    c["haar_amp4"] = _case(4, "cascade", 1, 2, 4, seed=11)
    c["two_layers_amp4"] = _case(4, "layered", 2, 2, 4)
    c["evolve"] = _case(5, "cross_mesh", 2, 2, 4, seed=3, batch=6, want=("evolve",))
    c["grad"] = _case(3, "cascade", 1, 2, 4, batch=4, want=("z", "grad"))
    c.update({f"amplitude_amp{a}": _case(4, "cascade", 1, 8 // a, a, seed=7,
                                         encoding="amplitude", feats=10) for a in (2, 4)})
    c["shots_noise"] = _case(4, "cascade", 1, 2, 4, seed=11, want=("z", "noise"),
                             noise=(0.05, 0.01), shots=512)
    return c


@pytest.fixture(scope="module")
def world():
    jm = JDV(JConfig(**STREAMS_CFG))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    X = np.random.default_rng(2).uniform(size=(10, 3)).astype(np.float32)
    payload = {"backend": "gate", "circuits": cases(),
               "streams": dict(cfg=STREAMS_CFG, params=params, X=X, data=2, amp=4)}
    future = start_world(8, sharded_cases, payload)
    # JAX's side while the world runs
    refs = {tag: _jax_z(c)[2] for tag, c in payload["circuits"].items()
            if c["want"] == ("z",)}
    return payload, refs, future.result()


def _jax_z(c):
    jc = JCircuit(c["n"], c["layers"], c["ansatz"], seed=c["seed"], encoding=c["encoding"])
    mesh = j_make_mesh(data=c["data"], amp=c["amp"])
    return jc, mesh, np.asarray(jax.jit(j_sharded_apply(jc, mesh))(c["params"], c["x"]))


@pytest.mark.parametrize("tag", [f"cascade_amp{a}" for a in (2, 4, 8)]
                         + [f"{a}_amp4" for a in ANSATZE]
                         + ["haar_amp4", "two_layers_amp4", "amplitude_amp2",
                            "amplitude_amp4"])
def test_forward_matches_jax(world, tag):
    _, refs, res = world
    want = refs[tag]
    for r in res:  # every rank holds the whole readout after the gather
        np.testing.assert_allclose(r[f"{tag}/z"], want, atol=5e-5)


def test_evolve_matches_jax(world):
    payload, _, res = world
    c = payload["circuits"]["evolve"]
    jc = JCircuit(c["n"], c["layers"], c["ansatz"], seed=c["seed"])
    mesh = j_make_mesh(data=2, amp=4)
    state = jc.prepare(c["x"])
    want = np.asarray(jax.jit(JSharded(jc, mesh).evolve)(c["params"], state))
    np.testing.assert_allclose(res[0]["evolve/evolve"], want, atol=5e-5)


def test_gradients_match_jax(world):
    """An amp-4 case's gradient: a psum whose backward summed instead of
    transposing, or a mean counting the amp copies wrong, is off by 4x."""
    payload, _, res = world
    c = payload["circuits"]["grad"]
    jc, mesh, _ = _jax_z(c)
    f = j_sharded_apply(jc, mesh)
    want = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(f(p, c["x"]) ** 2)))(c["params"]))
    for r in res:
        np.testing.assert_allclose(r["grad/grad"], want, atol=2e-4 * np.abs(want).max())


def test_shots_and_noise(world):
    """Noise scales the amp-summed readout by JAX's analytic factor; the
    shots are the unsharded engine's for the same generator on the same
    rows (JAX draws from jax.random, which torch does not replay)."""
    payload, _, res = world
    c = payload["circuits"]["shots_noise"]
    jc, mesh, _ = _jax_z(c)
    sc = JSharded(jc, mesh)
    from qcpinn_tpu.ops.measure import NoiseModel as JNoise

    want = np.asarray(jax.jit(lambda p, x: sc.apply(p, x, noise=JNoise(*c["noise"])))(
        c["params"], c["x"]))
    np.testing.assert_allclose(res[0]["shots_noise/noisy"], want, atol=5e-5)
    np.testing.assert_allclose(res[0]["shots_noise/noisy"],
                               res[0]["shots_noise/z"] * 0.95 * 0.98, atol=1e-6)
    circ = DVCircuit(c["n"], c["layers"], c["ansatz"], seed=c["seed"])
    for r in res:
        plain = circ.apply(torch.tensor(c["params"]), torch.tensor(r["shots_noise/rows"]),
                           shots=c["shots"], key=torch.Generator().manual_seed(7),
                           noise=NoiseModel(*c["noise"]))
        np.testing.assert_array_equal(r["shots_noise/shots"], plain.numpy())


def test_streams_compose_with_sharded_engine(world):
    """use_sharded + tangent streams: u, the residual and the reverse
    gradients of sum(r^2) against JAX's (JAX's limits: 2e-6 on u and r)."""
    payload, _, res = world
    c = payload["streams"]
    jm = JDV(JConfig(**STREAMS_CFG)).use_sharded(j_make_mesh(data=2, amp=4))
    u, r = jax.jit(lambda p, X: j_streams(jm, p, X))(c["params"], c["X"])
    np.testing.assert_allclose(res[0]["streams/u"], np.asarray(u), atol=2e-6)
    np.testing.assert_allclose(res[0]["streams/r"], np.asarray(r), atol=2e-6)
    g = jax.jit(jax.grad(lambda p: jnp.sum(j_streams(jm, p, c["X"])[1] ** 2)))(c["params"])
    got, want = jax.tree_util.tree_leaves(res[0]["streams/grads"]), jax.tree_util.tree_leaves(g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=2e-4 * max(np.abs(b).max(), 1e-6))
