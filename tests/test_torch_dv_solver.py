"""The port's DVSolver (qcpinn_tpu_torch/models/dv_solver.py) against the
JAX package's models/dv_solver.py on the same weights (through the params
bridge) and the same points: the forward on the plain block engine and on
the unrolled engine (its kernels' plain versions on the CPU) against the
JAX gate-by-gate circuit, one
streams train step at n = 7 on the unrolled engine against the JAX block
engine, and a toy-size ``north_star --solver plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models import DVSolver as JSolver
from qcpinn_tpu.physics.streams import dv_diffusion_residual_streams as j_streams
from qcpinn_tpu_torch import north_star as ns
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.models import DVSolver as TSolver
from qcpinn_tpu_torch.ops import sv_kernel as sk
from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
from qcpinn_tpu_torch.physics.operators_fwd import diffusion_operator_fwd as t_fwd
from qcpinn_tpu_torch.physics.streams import dv_diffusion_residual_streams as t_streams
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train.loop import TermSpec as TTerm
from qcpinn_tpu_torch.train.loop import make_train_step as t_make_train_step


def _models(n, hidden=6, ansatz="cross_mesh", seed=3):
    kw = dict(num_qubits=n, classic_network=(3, hidden, 1), q_ansatz=ansatz, seed=seed)
    jm = JSolver(JConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0))
    tm = TSolver(TConfig(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _assert_grads(model, want_tree):
    got = grads_to_jax_layout(model)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want_tree))
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want_tree)):
        scale = max(float(jnp.max(jnp.abs(w))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(w), atol=2e-4 * scale)


@pytest.mark.parametrize("backend", ["block", "unrolled"])
def test_forward_and_grads_match_jax(backend):
    jm, params, tm = _models(4)
    assert set(params) == {"pre", "q", "post"}
    tm.use_fused(backend)
    x = np.random.default_rng(1).uniform(size=(5, 3)).astype(np.float32)
    want, g_ref = jax.jit(lambda p, xx: (
        jm.apply(p, xx), jax.grad(lambda q: jnp.sum(jm.apply(q, xx) ** 2))(p)))(
        params, jnp.asarray(x))
    sk.reset_launches()
    out = tm(torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=3e-5)
    torch.sum(out**2).backward()
    _assert_grads(tm, g_ref)
    assert sk.LAUNCHES["unrolled_fwd_ref"] == (backend == "unrolled")
    assert tm.encode(torch.tensor(x)).shape == (5, 4)  # the angles alone


def test_unported_options_raise():
    # the noise fields build the channel, bound to the circuit's gate counts
    noisy = TSolver(TConfig(num_qubits=3, noise_depolarizing=0.1, noise_per_gate=0.01),
                    device="cpu")
    assert noisy.noise.depolarizing == 0.1 and len(noisy.noise.gate_counts) == 3
    tm = TSolver(TConfig(num_qubits=3), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tm.use_fused("pallas")
    assert type(tm.use_fused().qblock) is BlockFusedCircuit  # auto on the CPU
    z = tm(torch.rand(2, 3), detach_quantum=True)
    z.sum().backward()
    assert tm.q.grad is None and tm.post[0].weight.grad.any()


class _Fixed:
    """A sampler that returns preset points (the same in both packages)."""

    def __init__(self, X, func, to):
        self.X, self.func, self.to = X, func, to

    def sample(self, _key, n):
        X = self.to(self.X[:n])
        return X, self.func(X)


def test_streams_train_step_matches_jax():
    """One train step (streams residual on 8 points, five fused value walls
    of 2) of a narrow n = 7 DVSolver: the port through the unrolled engine
    (its plain versions here, inside make_train_step) against the JAX
    block engine's value and grad of the same loss."""
    n, b = 7, 8
    jm, params, tm = _models(n, hidden=5)
    jm.use_pallas(backend="block")
    tm.use_fused("unrolled")
    rng = np.random.default_rng(6)
    res = rng.uniform(size=(b, 3)).astype(np.float32)
    walls = {}
    for name, (col, v) in {"ic": (0, 0.0), "bcx0": (1, 0.0), "bcx1": (1, 1.0),
                           "bcy0": (2, 0.0), "bcy1": (2, 1.0)}.items():
        X = rng.uniform(size=(2, 3)).astype(np.float32)
        X[:, col] = v
        walls[name] = X

    terms = {"res": TTerm(_Fixed(res, tdd.r_true, torch.tensor), 1.0, b, "residual")}
    for name, X in walls.items():
        terms[name] = TTerm(_Fixed(X, tdd.u, torch.tensor), 10.0, len(X), "value")

    def j_loss(p):
        """make_train_step's fused loss: the streams residual term, then the
        five walls through one model call."""
        _, r = j_streams(jm, p, jnp.asarray(res))
        Xv = jnp.concatenate([jnp.asarray(X) for X in walls.values()])
        pv = jm.apply(p, Xv)
        total = jnp.mean((r - jdd.r_true(jnp.asarray(res))) ** 2)
        for k, X in enumerate(walls.values()):
            total += 10.0 * jnp.mean((pv[2 * k : 2 * k + 2] - jdd.u(jnp.asarray(X))) ** 2)
        return total

    l_ref, g_ref = jax.jit(jax.value_and_grad(j_loss))(params)
    captured = {}

    def t_update(grads, state, params):
        captured["t"] = grads
        return [torch.zeros_like(g) for g in grads], state

    topt_ = topt.GradientTransformation(lambda p: None, t_update)
    t_step, _ = t_make_train_step(tm, t_fwd, terms, topt_, TConfig(num_qubits=n),
                                  residual_fn=lambda X: t_streams(tm, X),
                                  fuse_value_terms=True)
    sk.reset_launches()
    plist = list(tm.parameters())
    _, _, t_metrics = t_step(plist, None, topt.plateau_init(), torch.Generator())
    # one evolve for the stream batch, one apply for the fused value batch
    assert sk.LAUNCHES["unrolled_fwd_ref"] == 2 and sk.LAUNCHES["unrolled_bwd_ref"] == 2
    for p, g in zip(plist, captured["t"]):
        p.grad = g
    np.testing.assert_allclose(float(t_metrics["loss"]), float(l_ref), rtol=2e-5)
    _assert_grads(tm, g_ref)


def test_north_star_plain_run_smoke():
    """``--solver plain`` at toy size on the CPU: one stage (no stage 1),
    the streams residual through the unrolled engine (n >= 10), and the
    streams evaluation on the 20^3 grid."""
    args = ns.parse_args("--solver plain --qubits 10 --batch 64 --hidden 4 "
                         "--backend unrolled --chunk 1 --total-steps 2 "
                         "--minutes 10".split())
    sk.reset_launches()
    r = ns.run(args, device="cpu")
    assert (r["solver"], r["backend"], r["steps"]) == ("plain", "FusedCircuit", 2)
    assert "stage1_steps" not in r
    assert np.isfinite([r["final_loss"], r["rel_l2_u"], r["rel_l2_r"]]).all()
    # two evolves a step; the evaluation is forward only, two a chunk
    chunks = -(-20**3 // 512)
    assert sk.LAUNCHES["unrolled_bwd_ref"] == 2 * 2
    assert sk.LAUNCHES["unrolled_fwd_ref"] == 2 * 2 + 2 * chunks
