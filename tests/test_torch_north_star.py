"""The port's 16-qubit north-star pieces against the JAX package, at small
size: the RBF head and its streams, the forward-mode operator, the mixture
sampler, the optimizer chain and plateau scheduler, the grid evaluation,
and one stage-1 and one stage-2 north-star step (make_train_step) on the
same weights and points."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.data import diffusion as jdd
from qcpinn_tpu.models import nn_core as jnc
from qcpinn_tpu.models.dv_fourier import DVFourierSolver as JSolver
from qcpinn_tpu.physics.operators_fwd import diffusion_operator_fwd as j_fwd
from qcpinn_tpu.physics.streams import dv_diffusion_residual_streams as j_streams
from qcpinn_tpu.train import TermSpec as JTerm
from qcpinn_tpu.train import make_train_step as j_make_train_step
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu.utils.evaluation import evaluate_relative_l2 as j_eval
from qcpinn_tpu_torch import north_star as ns
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.models import nn_core as tnc
from qcpinn_tpu_torch.models.dv_fourier import DVFourierSolver as TSolver
from qcpinn_tpu_torch.ops import loop_kernel as lk
from qcpinn_tpu_torch.physics.operators_fwd import diffusion_operator_fwd as t_fwd
from qcpinn_tpu_torch.physics.streams import dv_diffusion_residual_streams as t_streams
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train.loop import TermSpec as TTerm
from qcpinn_tpu_torch.train.loop import make_train_step as t_make_train_step
from qcpinn_tpu_torch.utils.evaluation import evaluate_relative_l2 as t_eval


def _models(n, hidden=8, rbf=2, mapping=4, skip=4, seed=3):
    kw = dict(num_qubits=n, classic_network=(3, hidden, 1), q_ansatz="cross_mesh",
              seed=seed, scheduler="cosine", epochs=10)
    centers = np.random.default_rng(seed).uniform(0.2, 0.8, size=(rbf, 3)).astype(np.float32)
    jm = JSolver(JConfig(**kw), mapping_size=mapping, skip_dim=skip, rbf_count=rbf,
                 rbf_centers=jnp.asarray(centers) if rbf else None)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TSolver(TConfig(**kw), mapping_size=mapping, skip_dim=skip, rbf_count=rbf,
                 rbf_centers=torch.tensor(centers) if rbf else None, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _assert_grads(model, want_tree):
    got = grads_to_jax_layout(model)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want_tree))
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want_tree)):
        scale = max(float(jnp.max(jnp.abs(w))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(w), atol=2e-4 * scale)


# -- RBF head ------------------------------------------------------------------


def test_rbf_apply_matches_jax_including_the_clamp():
    rng = np.random.default_rng(0)
    p = {"c": rng.uniform(size=(3, 3)), "w": 8.0 * (1 + 0.25 * rng.normal(size=(3, 3))),
         "v": rng.normal(size=(3, 3)), "a": rng.normal(size=(3, 2))}
    p["v"][1] = -200.0  # q far below -30: both packages clamp the exponent
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.uniform(size=(6, 3)).astype(np.float32)
    want = jnc.rbf_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tnc.rbf_apply({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    a1 = {**p, "a": p["a"][:, 0]}
    assert tnc.rbf_apply({k: torch.tensor(v) for k, v in a1.items()}, torch.tensor(x)).shape == (6, 1)


def test_rbf_init_and_centers_from_samples():
    gen = torch.Generator().manual_seed(0)
    X = torch.rand(50, 3, generator=gen)
    w = torch.zeros(50)
    w[[3, 17]] = torch.tensor([1.0, -2.0])  # |weights|: only these rows
    c = tnc.rbf_centers_from_samples(gen, X, w, 8, jitter=0.0)
    assert c.shape == (8, 3)
    assert all(any(torch.equal(row, X[i]) for i in (3, 17)) for row in c)
    head = tnc.rbf_init(3, 4, centers=c[:4], width=8.0, out_dim=1, generator=gen)
    assert set(head.keys()) == {"c", "w", "v", "a"}
    assert torch.equal(head["c"].data, c[:4]) and not head["v"].data.any()
    assert torch.all(head["a"].data == 0.1) and head["w"].shape == (4, 3)


def test_bridge_round_trips_rbf_leaves():
    jm, params, tm = _models(4)
    sd = tm.state_dict()
    for k in ("c", "w", "v", "a"):
        np.testing.assert_array_equal(sd[f"rbf.{k}"].numpy(), np.asarray(params["rbf"][k]))
    x = np.random.default_rng(1).uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))), atol=1e-5)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2)))(params)
    torch.sum(tm(torch.tensor(x)) ** 2).backward()
    _assert_grads(tm, want)


def test_rbf_streams_match_jax():
    jm, params, tm = _models(3, hidden=10)
    X = np.random.default_rng(2).uniform(0.1, 0.9, size=(8, 3)).astype(np.float32)
    u_ref, r_ref = j_streams(jm, params, jnp.asarray(X))
    u, r = t_streams(tm, torch.tensor(X))
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(u_ref), atol=2e-5)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(r_ref), rtol=5e-3, atol=5e-4)


def test_diffusion_operator_fwd_matches_jax():
    jm, params, tm = _models(3, hidden=12)
    X = np.random.default_rng(3).uniform(0.1, 0.9, size=(16, 3)).astype(np.float32)
    u_ref, r_ref = j_fwd(lambda Xp: jm.apply(params, Xp), jnp.asarray(X))
    u, r = t_fwd(tm, torch.tensor(X))
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(u_ref), atol=1e-5)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(r_ref), rtol=2e-3, atol=2e-4)
    _, r_an = t_fwd(tdd.u, torch.tensor(X))  # the analytic oracle
    np.testing.assert_allclose(r_an.numpy(), tdd.r_true(torch.tensor(X)).numpy(),
                               rtol=2e-3, atol=2e-4)


# -- sampling ------------------------------------------------------------------


def test_mixture_sampler_row_rule_and_targets():
    s = tdd.pulse_residual_sampler(frac=0.5, sigma=1e-6)
    X, y = s.sample(torch.Generator().manual_seed(0), 11)
    # the first frac * n rows (6 of 11) are focused in x and y, t stays uniform
    np.testing.assert_allclose(X[:6, 1:].numpy(), 0.5, atol=1e-4)
    assert float((X[6:, 1:] - 0.5).abs().min()) > 1e-4
    assert len(set(X[:, 0].tolist())) == 11
    np.testing.assert_allclose(y.numpy(), np.asarray(jdd.r_true(jnp.asarray(X.numpy()))),
                               rtol=1e-5, atol=1e-5)
    wide = tdd.MixtureSampler(tdd._box([[0, 0, 0], [1, 1, 1]]), tdd.u,
                              focus=np.float32([0.0, 1.0, 0.5]),
                              sigma=np.float32([5.0, 5.0, 5.0]), frac=1.0)
    Xw, yw = wide.sample(torch.Generator().manual_seed(1), 64)
    assert float(Xw.min()) >= 0.0 and float(Xw.max()) <= 1.0  # clipped to the box
    assert (Xw == 0.0).any() and (Xw == 1.0).any()
    np.testing.assert_allclose(yw.numpy(), np.asarray(jdd.u(jnp.asarray(Xw.numpy()))),
                               rtol=1e-5, atol=1e-6)


# -- optimizer and scheduler -----------------------------------------------------


def test_cosine_schedule_matches_optax():
    lr, e = 5e-3, 7
    want = optax.cosine_decay_schedule(lr, decay_steps=e)
    got = topt.cosine_decay_schedule(lr, e)
    assert got(0) == lr
    for k in range(e + 3):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("schedule", ["cosine", "plateau"])
def test_make_optimizer_matches_jax(schedule):
    """Three clipped-Adam steps (global norms above and below the clip) on a
    small tree against the JAX make_optimizer (optax.chain)."""
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    grads = [[s * rng.normal(size=a.shape).astype(np.float32) for a in p0]
             for s in (3.0, 0.1, 1.5)]
    kw = dict(grad_clip=1.0, schedule=schedule, epochs=4)
    jo = jopt.make_optimizer(5e-3, **kw)
    to = topt.make_optimizer(5e-3, **kw)
    jp = [jnp.asarray(a) for a in p0]
    js = jo.init(jp)
    tp = [torch.tensor(a) for a in p0]
    ts = to.init(tp)
    for g in grads:
        upd, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = to.update([torch.tensor(a) for a in g], ts, tp)
        topt.apply_updates(tp, tu)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_plateau_scheduler_matches_jax():
    js, ts = jopt.plateau_init(), topt.plateau_init()
    for loss in (3.0, 2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0):
        js = jopt.plateau_update(js, jnp.float32(loss), factor=0.5, patience=2)
        ts = topt.plateau_update(ts, torch.tensor(loss), factor=0.5, patience=2)
        assert float(ts.best) == float(js.best)
        assert int(ts.bad_epochs) == int(js.bad_epochs)
        assert float(ts.scale) == float(js.scale)
    assert float(ts.scale) == 0.25
    u = topt.scale_updates([torch.ones(2)], ts.scale)
    assert torch.equal(u[0], torch.full((2,), 0.25))


# -- the north-star steps ----------------------------------------------------------


class _Fixed:
    """A sampler that returns preset points (the same in both packages)."""

    def __init__(self, X, func, to):
        self.X, self.func, self.to = X, func, to

    def sample(self, _key, n):
        X = self.to(self.X[:n])
        return X, self.func(X)


def _points(b, rng):
    third = max(b // 3, 1)
    res = tdd.pulse_residual_sampler().sample(torch.Generator().manual_seed(5), b)[0].numpy()
    walls = {}
    for name, (col, v) in {"ic": (0, 0.0), "bcx0": (1, 0.0), "bcx1": (1, 1.0),
                           "bcy0": (2, 0.0), "bcy1": (2, 1.0)}.items():
        X = rng.uniform(size=(third, 3)).astype(np.float32)
        X[:, col] = v
        walls[name] = X
    return res, walls


def _terms(res, walls, b, jax_side: bool):
    to = jnp.asarray if jax_side else torch.tensor
    dd = jdd if jax_side else tdd
    Term = JTerm if jax_side else TTerm
    terms = {"res": Term(_Fixed(res, dd.r_true, to), 1.0, b, "residual")}
    for name, X in walls.items():
        terms[name] = Term(_Fixed(X, dd.u, to), 10.0, len(X), "value")
    return terms


def _j_step(jm, params, terms, cfg, residual_fn, apply_fn):
    captured = {}

    def update(grads, state, params=None):
        captured["g"] = grads  # eager: concrete grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), state

    opt = optax.GradientTransformation(lambda p: optax.EmptyState(), update)
    step_fn, _ = j_make_train_step(apply_fn, j_fwd, terms, opt, cfg,
                                   residual_fn=residual_fn, fuse_value_terms=True)
    _, metrics = step_fn((params, opt.init(params), jopt.plateau_init()),
                         (jax.random.PRNGKey(0), jnp.int32(0)))
    return float(metrics["loss"]), captured["g"]


def _t_step(tm, terms, cfg, residual_fn):
    captured = {}

    def update(grads, state, params):
        captured["g"] = grads
        return [torch.zeros_like(g) for g in grads], state

    opt = topt.GradientTransformation(lambda p: None, update)
    step_fn, _ = t_make_train_step(tm, t_fwd, terms, opt, cfg,
                                   residual_fn=residual_fn, fuse_value_terms=True)
    params = list(tm.parameters())
    _, _, metrics = step_fn(params, None, topt.plateau_init(), torch.Generator())
    for p, g in zip(params, captured["g"]):
        p.grad = g
    return float(metrics["loss"])


def test_north_star_stage2_step_matches_jax():
    """One stage-2 step (streams residual, RBF head, five fused value walls,
    focused residual points) at n = 4, B = 8: the port through the loop
    engine (its plain versions here) against the JAX block engine."""
    n, b = 4, 8
    jm, params, tm = _models(n)
    jm.use_pallas(backend="block")
    tm.use_fused("loop")
    res, walls = _points(b, np.random.default_rng(6))
    jcfg = JConfig(num_qubits=n, scheduler="cosine")
    l_ref, g_ref = _j_step(jm, params, _terms(res, walls, b, True), jcfg,
                           lambda p, X: j_streams(jm, p, X), jm.apply)
    lk.reset_launches()
    loss = _t_step(tm, _terms(res, walls, b, False), TConfig(num_qubits=n, scheduler="cosine"),
                   lambda X: t_streams(tm, X))
    # one evolve for the stream batch, one for the fused value batch
    assert lk.LAUNCHES["gate_loop_fwd_ref"] == 2 and lk.LAUNCHES["gate_loop_bwd_ref"] == 2
    np.testing.assert_allclose(loss, l_ref, rtol=2e-5)
    _assert_grads(tm, g_ref)


def test_north_star_stage1_step_matches_jax():
    """One stage-1 step: zeroed quantum block, residual by nested forward
    AD; the quantum parameters get a zero gradient in both packages."""
    n, b = 4, 8
    jm, params, tm = _models(n)

    class _JZeroQ:
        def apply(self, qp, x, **kw):
            return jnp.zeros((x.shape[0], n), x.dtype)

    jm._fused = _JZeroQ()
    tm._fused = ns.ZeroQ(n)
    res, walls = _points(b, np.random.default_rng(7))
    l_ref, g_ref = _j_step(jm, params, _terms(res, walls, b, True),
                           JConfig(num_qubits=n, scheduler="cosine"), None, jm.apply)
    loss = _t_step(tm, _terms(res, walls, b, False), TConfig(num_qubits=n, scheduler="cosine"),
                   None)
    np.testing.assert_allclose(loss, l_ref, rtol=2e-5)
    _assert_grads(tm, g_ref)
    assert not tm.q.grad.any()


def test_train_step_refuses_unported_modes():
    cfg = TConfig(num_qubits=4)
    terms = {"res": TTerm(None, 1.0, 4, "residual")}
    opt = topt.make_optimizer(1e-3)
    with pytest.raises(NotImplementedError, match="item 9"):
        t_make_train_step(None, t_fwd, terms, opt, cfg, balancer="ema")
    with pytest.raises(NotImplementedError, match="item 9"):
        t_make_train_step(None, t_fwd, terms, opt, TConfig(gradient_mode="spsa"))
    with pytest.raises(NotImplementedError, match="item 13"):
        t_make_train_step(None, t_fwd, terms, opt, cfg, mesh=object())
    with pytest.raises(ValueError, match="balancer"):
        t_make_train_step(None, t_fwd, terms, opt, cfg, balancer="bogus")


def test_evaluate_relative_l2_matches_jax():
    jm, params, tm = _models(3, hidden=8)
    want = j_eval(jm.apply, params, jdd.u, analytic_r=jdd.r_true, operator=j_fwd,
                  num=5, batch=64)
    got = t_eval(tm, tdd.u, analytic_r=tdd.r_true, operator=t_fwd, num=5, batch=64,
                 device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


# -- the entry point -----------------------------------------------------------------


def test_north_star_cli_shape():
    args = ns.parse_args([])
    assert (args.qubits, args.batch, args.hidden, args.mapping, args.ff_scale,
            args.skip_dim, args.rbf, args.rbf_width, args.backend, args.chunk) == (
        16, 256, 64, 32, 4.0, 32, 8, 8.0, "auto", 25)
    terms = ns.make_terms(args)
    assert list(terms) == ["res", "ic", "bcx0", "bcx1", "bcy0", "bcy1"]
    assert terms["res"].kind == "residual" and terms["res"].batch == 256
    assert isinstance(terms["res"].sampler, tdd.MixtureSampler)
    assert all(terms[k].batch == 85 and terms[k].weight == 10.0 for k in list(terms)[1:])
    for solver in ("plain", "classical"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ns.build_model(ns.parse_args(["--solver", solver]), "cpu")


def test_north_star_run_smoke():
    """The whole script at toy size on the CPU: stage 1 (zeroed circuit),
    the handoff, stage 2 through the loop engine with streams (n >= 10),
    and the streams evaluation on the 20^3 grid."""
    args = ns.parse_args(
        "--qubits 10 --batch 64 --hidden 4 --mapping 2 --skip-dim 2 --rbf 2 "
        "--backend loop --stage1-minutes 1e-9 --stage1-steps 500 --chunk 1 "
        "--total-steps 2 --minutes 10".split())
    lk.reset_launches()
    r = ns.run(args, device="cpu")
    assert r["backend"] == "LoopFusedCircuit"
    assert (r["stage1_steps"], r["stage2_steps"], r["stage2_timed_steps"]) == (500, 2, 1)
    assert np.isfinite([r["final_loss"], r["rel_l2_u"], r["rel_l2_r"]]).all()
    # two evolves a stage-2 step; the evaluation is forward only, two a chunk
    chunks = -(-20**3 // 512)
    assert lk.LAUNCHES["gate_loop_bwd_ref"] == 2 * 2
    assert lk.LAUNCHES["gate_loop_fwd_ref"] == 2 * 2 + 2 * chunks
