"""The stage-1 forward jet (DVFourierSolver.jet, physics/jet.py) against the
JAX package's nested-jvp diffusion operator and against the port's own
(its plain version), at small size: n = 4, hidden 10, Fourier map 4, skip
4, two RBF units, B = 16; and one stage-1 step built by
``north_star.make_stage`` (the jet path) against JAX's step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models.dv_fourier import DVFourierSolver as JSolver
from qcpinn_tpu.physics.operators_fwd import diffusion_operator_fwd as j_fwd
from qcpinn_tpu.train import TermSpec as JTerm
from qcpinn_tpu.train import make_train_step as j_make_train_step
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu_torch import north_star as ns
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.models.dv_fourier import DVFourierSolver as TSolver
from qcpinn_tpu_torch.models.dv_fourier import ZeroQ
from qcpinn_tpu_torch.physics.jet import diffusion_jet
from qcpinn_tpu_torch.physics.operators_fwd import diffusion_operator_fwd as t_fwd
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train.loop import TermSpec as TTerm

N, HIDDEN, B = 4, 10, 16
# test_diffusion_operator_fwd_matches_jax's limits; a tenth of them
# against the port's nested-jvp operator
U_ATOL, R_RTOL, R_ATOL = 1e-5, 2e-3, 2e-4


class _JZeroQ:
    def apply(self, qp, x, **kw):
        return jnp.zeros((x.shape[0], N), x.dtype)


def _models(v=None, seed=3):
    """The stage-1 model in both packages on the same weights; ``v``
    replaces the RBF head's linear term (to drive its exponent past the
    clamp)."""
    kw = dict(num_qubits=N, classic_network=(3, HIDDEN, 1), q_ansatz="cross_mesh",
              seed=seed, scheduler="cosine", epochs=10)
    centers = np.random.default_rng(seed).uniform(0.2, 0.8, size=(2, 3)).astype(np.float32)
    jm = JSolver(JConfig(**kw), mapping_size=4, skip_dim=4, rbf_count=2,
                 rbf_centers=jnp.asarray(centers))
    params = jm.init(jax.random.PRNGKey(0))
    if v is not None:
        params = {**params, "rbf": {**params["rbf"], "v": jnp.asarray(v)}}
    tm = TSolver(TConfig(**kw), mapping_size=4, skip_dim=4, rbf_count=2,
                 rbf_centers=torch.tensor(centers), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    jm._fused = _JZeroQ()
    tm._fused = ZeroQ(N)
    return jm, params, tm


def _points(seed=3):
    return np.random.default_rng(seed).uniform(0.1, 0.9, size=(B, 3)).astype(np.float32)


# the second case's linear term sends the first unit's exponent far below
# -30 wherever x > 0.2: there the clamp holds and the unit has no tangent
CLAMPED_V = np.float32([[0.0, -400.0, 0.0], [0.3, -0.2, 0.5]])


@pytest.mark.parametrize("v", [None, CLAMPED_V], ids=["free", "clamped"])
def test_jet_matches_jax_operator(v):
    jm, params, tm = _models(v)
    X = _points()
    u_ref, r_ref = j_fwd(lambda Xp: jm.apply(params, Xp), jnp.asarray(X))
    u, r = diffusion_jet(tm, torch.tensor(X))
    assert u.shape == (B, 1) and r.shape == (B, 1)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(u_ref), atol=U_ATOL)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(r_ref), rtol=R_RTOL,
                               atol=R_ATOL)


@pytest.mark.parametrize("v", [None, CLAMPED_V], ids=["free", "clamped"])
def test_jet_matches_nested_jvp(v):
    _, _, tm = _models(v)
    X = torch.tensor(_points())
    if v is not None:  # the clamp holds at some points and not at others
        d = X[:, None, :] - tm.rbf["c"][None]
        q = ((tm.rbf["w"][None] * d) ** 2).sum(-1) + (tm.rbf["v"][None] * X[:, None]).sum(-1)
        assert (q < -30).any() and (q >= -30).any()
    u_ref, r_ref = t_fwd(tm, X)
    u, r = diffusion_jet(tm, X)
    np.testing.assert_allclose(u.detach().numpy(), u_ref.detach().numpy(),
                               atol=U_ATOL / 10)
    np.testing.assert_allclose(r.detach().numpy(), r_ref.detach().numpy(),
                               rtol=R_RTOL / 10, atol=R_ATOL / 10)


@pytest.mark.parametrize("cols2", [range(1, 3), range(0, 3), range(2, 3)],
                         ids=["xy", "txy", "y"])
def test_model_jet_channels_match_jvp(cols2):
    """Each channel of DVFourierSolver.jet against torch.func.jvp of the
    model (nested for the second order), at the clamped RBF case and for
    second-order channels along other input columns than the residual's."""
    _, _, tm = _models(CLAMPED_V)
    X = torch.tensor(_points())
    out, t_out = tm.jet(X, cols2)
    assert out.shape == (B, 1) and t_out.shape == (3 + len(cols2), B, 1)
    np.testing.assert_allclose(out.detach().numpy(), tm(X).detach().numpy(), atol=U_ATOL / 10)

    def unit(c):
        t = torch.zeros_like(X)
        t[:, c] = 1.0
        return t

    def d1(Xp, c):
        return torch.func.jvp(tm, (Xp,), (unit(c),))[1]

    want = [d1(X, c) for c in range(3)]
    want += [torch.func.jvp(lambda Xp, c=c: d1(Xp, c), (X,), (unit(c),))[1] for c in cols2]
    for k, w in enumerate(want):
        np.testing.assert_allclose(t_out[k].detach().numpy(), w.detach().numpy(),
                                   rtol=R_RTOL / 10, atol=R_ATOL / 10, err_msg=f"channel {k}")


def test_jet_refuses_a_live_quantum_block():
    _, _, tm = _models()
    tm._fused = None
    with pytest.raises(ValueError, match="ZeroQ"):
        diffusion_jet(tm, torch.tensor(_points()))


# -- one stage-1 step through make_stage (the jet) against JAX's ------------


class _Fixed:
    def __init__(self, X, func, to):
        self.X, self.func, self.to = X, func, to

    def sample(self, _key, n):
        X = self.to(self.X[:n])
        return X, self.func(X)


def _terms(res, walls, jax_side: bool):
    to = jnp.asarray if jax_side else torch.tensor
    dd = jdd if jax_side else tdd
    Term = JTerm if jax_side else TTerm
    terms = {"res": Term(_Fixed(res, dd.r_true, to), 1.0, len(res), "residual")}
    for name, X in walls.items():
        terms[name] = Term(_Fixed(X, dd.u, to), 10.0, len(X), "value")
    return terms


def _walls(rng, third):
    walls = {}
    for name, (col, v) in {"ic": (0, 0.0), "bcx0": (1, 0.0), "bcx1": (1, 1.0),
                           "bcy0": (2, 0.0), "bcy1": (2, 1.0)}.items():
        X = rng.uniform(size=(third, 3)).astype(np.float32)
        X[:, col] = v
        walls[name] = X
    return walls


def test_stage1_jet_step_matches_jax():
    """make_stage('stage1') (the jet residual, five fused value walls, RBF
    head) against JAX's stage-1 step (nested jvps) on the same weights and
    points: loss rtol 2e-5, every grad atol 2e-4 * max(|ref|, 1e-3), the
    quantum parameters' grad zero."""
    jm, params, tm = _models()
    rng = np.random.default_rng(7)
    res = tdd.pulse_residual_sampler().sample(torch.Generator().manual_seed(5), B)[0].numpy()
    walls = _walls(rng, B // 3)

    captured = {}

    def j_update(grads, state, params=None):
        captured["j"] = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), state

    jopt_ = optax.GradientTransformation(lambda p: optax.EmptyState(), j_update)
    j_step, _ = j_make_train_step(jm.apply, j_fwd, _terms(res, walls, True), jopt_,
                                  JConfig(num_qubits=N, scheduler="cosine"),
                                  fuse_value_terms=True)
    _, metrics = j_step((params, jopt_.init(params), jopt.plateau_init()),
                        (jax.random.PRNGKey(0), jnp.int32(0)))

    def t_update(grads, state, params):
        captured["t"] = grads
        return [torch.zeros_like(g) for g in grads], state

    args = ns.parse_args(["--qubits", str(N), "--hidden", str(HIDDEN)])
    cfg = TConfig(num_qubits=N, scheduler="cosine")
    stage = ns.make_stage(tm, cfg, args, _terms(res, walls, False), "stage1",
                          optimizer=topt.GradientTransformation(lambda p: None, t_update))
    assert isinstance(tm.qblock, ZeroQ)
    loss = float(stage.step()["loss"])
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=2e-5)
    for p, g in zip(stage.params, captured["t"]):
        p.grad = g
    got = grads_to_jax_layout(tm)
    want = captured["j"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want))
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        scale = max(float(jnp.max(jnp.abs(w))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(w), atol=2e-4 * scale)
    assert not tm.q.grad.any()
