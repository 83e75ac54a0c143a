"""The port's parallel layer (qcpinn_tpu_torch/parallel/mesh.py and
collectives.py) and its users, on a gloo world of 4 CPU processes, against
the JAX package on the conftest's 8-device mesh (tests/test_parallel.py's
cases, at 4 ranks): the mesh, the data-parallel forward, one train step's metrics and
gradients (data-parallel, amp-sharded with the nested-jvp residual through
the collectives, the Hopfield model's global attention with its reverse
Hessian residual) within 2e-4 x max|ref| of each leaf of JAX's, training
histories against the single-device run (JAX's rtol 1e-4 / atol 1e-6),
``cli train --data-parallel`` and the driver entry points. One world runs
every case (``torch_parallel_worker.parallel_cases``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models import ClassicalSolver as JClassical
from qcpinn_tpu.models import DVSolver as JDV
from qcpinn_tpu.parallel import make_mesh as j_make_mesh
from qcpinn_tpu.physics import get_operator as j_get_operator
from qcpinn_tpu.train import diffusion_terms as j_diffusion_terms
from qcpinn_tpu.train import inject_balancer_params as j_inject
from qcpinn_tpu.train import make_train_step as j_make_train_step
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu_torch import cli
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import gaussian_pulse_samplers
from qcpinn_tpu_torch.models import ClassicalSolver as TClassical
from qcpinn_tpu_torch.models import DVSolver as TDV
from qcpinn_tpu_torch.physics import get_operator
from qcpinn_tpu_torch.train import diffusion_terms, train
from torch_parallel_worker import parallel_cases, start_world


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _points(b, seed=11):
    rng = np.random.default_rng(seed)
    X = {"res": rng.uniform(size=(b, 3)), "bc1": rng.uniform(size=(b // 3, 3)),
         "ics": rng.uniform(size=(b // 3, 3))}
    X["bc1"][:, 1] = 0.0
    X["ics"][:, 0] = 0.0
    return {k: v.astype(np.float32) for k, v in X.items()}


class _JFixed:
    def __init__(self, X, func):
        self.X, self.func = X, func

    def sample(self, _key, n):
        X = jnp.asarray(self.X[:n])
        return X, self.func(X)


# one train step on fixed points: (data, amp, config, operator mode, fused
# value terms, balancer, amp backend)
STEPS = {
    "dv_data4": (4, 1, dict(num_qubits=2, classic_network=(3, 8, 1), seed=5), "fwd", True,
                 "none", "gate"),
    "dv_amp2_gate": (2, 2, dict(num_qubits=3, q_ansatz="cross_mesh",
                                classic_network=(3, 8, 1), seed=5), "fwd", True, "none",
                     "gate"),
    "dv_amp2_block": (2, 2, dict(num_qubits=3, q_ansatz="cross_mesh",
                                 classic_network=(3, 8, 1), seed=5), "fwd", True, "none",
                      "block"),
    "hopfield_data4": (4, 1, dict(solver="Classical", classic_network=(3, 16, 1), seed=0),
                       "rev", False, "ema", "gate"),
}
STEP_B = 9
# training runs against single-device: (data, amp, config, operator mode)
TRAINS = {
    "data4": (4, 1, dict(num_qubits=2, classic_network=(3, 8, 1), epochs=4, batch_size=16,
                         print_every=4, seed=3), "fwd"),
    "amp2": (2, 2, dict(num_qubits=3, q_ansatz="cross_mesh", classic_network=(3, 8, 1),
                        epochs=4, batch_size=8, print_every=4, seed=5), "fwd"),
    "hopfield_data4": (4, 1, dict(solver="Classical", classic_network=(3, 16, 1), epochs=4,
                                  batch_size=16, print_every=4, seed=0), "rev"),
}
CLI_ARGV = ["train", "--problem", "diffusion", "--solver", "DV", "--epochs", "2",
            "--num-qubits", "2", "--hidden-dim", "6", "--batch-size", "12", "--eval-grid", "4",
            "--print-every", "1", "--no-plots"]


def _jmodel(cfg):
    return (JClassical if cfg.get("solver") == "Classical" else JDV)(JConfig(**cfg))


def _jax_terms(pts):
    return j_diffusion_terms({"res": _JFixed(pts["res"], jdd.r),
                              "bc1": _JFixed(pts["bc1"], jdd.u),
                              "ics": _JFixed(pts["ics"], jdd.u)}, STEP_B)


def _jax_params(name):
    _, _, cfg, _, _, balancer, _ = STEPS[name]
    params = _jmodel(cfg).init(jax.random.PRNGKey(2))
    return _np(j_inject(params, _jax_terms(_points(STEP_B)), balancer))


def _jax_step(name, params):
    """JAX's step on the same points and parameters: (metrics, gradients)."""
    _, _, cfg, op, fuse, balancer, _ = STEPS[name]
    jm = _jmodel(cfg)
    terms = _jax_terms(_points(STEP_B))
    seen = {}

    def update(grads, state, params=None):
        seen["g"] = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), state

    jo = optax.GradientTransformation(lambda p: optax.EmptyState(), update)
    step, _ = j_make_train_step(jm.apply, j_get_operator("diffusion", op), terms, jo,
                                JConfig(**cfg), fuse_value_terms=fuse, balancer=balancer)
    def run(state, xs):
        _, metrics = step(state, xs)
        return metrics, seen["g"]

    metrics, grads = jax.jit(run)((params, jo.init(params), jopt.plateau_init()),
                                  (jax.random.PRNGKey(0), jnp.int32(0)))
    return {k: float(v) for k, v in metrics.items()}, _np(grads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_cli"))
    jm = JDV(JConfig(num_qubits=3, classic_network=(3, 10, 1)))
    hm = JClassical(JConfig(solver="Classical", classic_network=(3, 16, 1)))
    x = np.random.default_rng(1).uniform(size=(32, 3)).astype(np.float32)
    params = {name: _jax_params(name) for name in STEPS}
    payload = {
        "forward": dict(cfg=dict(num_qubits=3, classic_network=(3, 10, 1)),
                        params=_np(jm.init(jax.random.PRNGKey(0))), x=x),
        "hopfield": dict(cfg=dict(solver="Classical", classic_network=(3, 16, 1)),
                         params=_np(hm.init(jax.random.PRNGKey(0))), x=x),
        "steps": {name: dict(data=d, amp=a, cfg=cfg, op=op, fuse=fuse, balancer=bal,
                             backend=backend, params=params[name], points=_points(STEP_B),
                             b=STEP_B)
                  for name, (d, a, cfg, op, fuse, bal, backend) in STEPS.items()},
        "train": {name: dict(data=d, amp=a, cfg=cfg, op=op)
                  for name, (d, a, cfg, op) in TRAINS.items()},
        "cli": dict(out=out, argv=[*CLI_ARGV, "--data-parallel", "--output-dir", out,
                                   "--metrics-json", os.path.join(out, "m.json")]),
        "multichip": ["--device", "cpu", "--amp", "2", "--qubits", "4", "--steps", "2"],
    }
    future = start_world(4, parallel_cases, payload)
    # the amp-sharded cases, gate and block, hold to one single-device step
    refs = {name: _jax_step(name, params[name]) for name in STEPS if name != "dv_amp2_block"}
    refs["dv_amp2_block"] = refs["dv_amp2_gate"]
    return payload, refs, future.result()


def test_mesh_shape(world):
    _, _, res = world
    for r in res:
        assert r["shape"] == {"data": 4, "amp": 1}
        assert r["shape_error"] == "data(3) * amp(2) != device count (4)"


def test_sharded_forward_matches_replicated(world):
    payload, _, res = world
    c = payload["forward"]
    want = np.asarray(jax.jit(JDV(JConfig(**c["cfg"])).apply)(c["params"], c["x"]))
    for r in res:
        np.testing.assert_allclose(r["forward"], want, atol=1e-6)


def test_hopfield_sharded_matches_single_device(world):
    """The B x B attention stays global under the data axis: keys and values
    are gathered, JAX's GSPMD semantics."""
    payload, _, res = world
    c = payload["hopfield"]
    want = np.asarray(jax.jit(JClassical(JConfig(**c["cfg"])).apply)(c["params"], c["x"]))
    for r in res:
        np.testing.assert_allclose(r["hopfield"], want, atol=1e-5)


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_matches_jax(world, name):
    """Every rank's step: the global term values (what the balancers and the
    history see) rtol 2e-5, the averaged gradients within 2e-4 x max|ref|
    of each leaf of JAX's single-device gradient (an A-fold psum backward
    fails the amp cases by 2x)."""
    _, refs, res = world
    want_m, want_g = refs[name]
    for r in res:
        got_m, got_g = r[f"step_{name}"]
        for k, v in want_m.items():
            np.testing.assert_allclose(got_m[k], v, rtol=2e-5, err_msg=k)
        got, want = jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4 * max(np.abs(b).max(), 1e-6))


@pytest.mark.parametrize("name", list(TRAINS))
def test_training_matches_single_device(world, name):
    """The data-parallel and the amp-sharded runs follow the single-device
    trajectory (the same sample stream on every rank)."""
    payload, _, res = world
    _, _, cfg, op = TRAINS[name]
    tcfg = TConfig(**cfg)
    model = (TClassical if tcfg.solver == "Classical" else TDV)(tcfg, device="cpu")
    _, want = train(model, tcfg, diffusion_terms(gaussian_pulse_samplers(), tcfg.batch_size),
                    get_operator("diffusion", op), device="cpu")
    for r in res:
        assert len(r[f"train_{name}"]) == tcfg.epochs
        np.testing.assert_allclose(r[f"train_{name}"], want, rtol=1e-4, atol=1e-6)


def test_cli_train_data_parallel(world, tmp_path):
    """Rank 0 alone writes its run directory and metrics; the run matches the
    same command without the flag."""
    payload, _, res = world
    out = payload["cli"]["out"]
    assert all(r["cli_rc"] == 0 for r in res)
    dirs = res[0]["cli_dirs"]
    assert len([d for d in dirs if d.startswith("DV-cascade-diffusion")]) == 1, dirs
    with open(os.path.join(out, "m.json")) as f:
        got = json.load(f)
    ref = str(tmp_path / "m.json")
    assert cli.main([*CLI_ARGV, "--output-dir", str(tmp_path), "--metrics-json", ref],
                    device="cpu") == 0
    with open(ref) as f:
        want = json.load(f)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-3, err_msg=k)


def test_driver_entry_points(world):
    """graft_entry's full step on the world (amp 2, both engines) and the
    multichip walkthrough (three runs, within float drift)."""
    _, _, res = world
    for r in res:
        d = r["dryrun"]
        assert d["mesh"] == {"data": 2, "amp": 2}
        assert np.isfinite(d["loss"]) and np.isfinite(d["loss_block"])
        np.testing.assert_allclose(d["loss_block"], d["loss"], rtol=1e-5)
        m = r["multichip"]
        assert len(m["single"]) == 2 and m["drift"] < 1e-4
    assert res[0]["dryrun"] == res[-1]["dryrun"]
