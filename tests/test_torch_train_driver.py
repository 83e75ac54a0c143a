"""The port's training driver (train/loop.py) against the JAX package:
``diffusion_terms``, one step with each loss balancer and with weight
decay (make_train_step), five steps of ``train()`` on fixed points, the
best-validation restore, and resuming from a checkpoint (bit-equal on the
CPU). Weights cross by the bridge; the points are the same numpy arrays in
both packages (torch generators do not replay jax.random)."""

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
from qcpinn_tpu.physics import get_operator as j_get_operator
from qcpinn_tpu.train import TermSpec as JTerm
from qcpinn_tpu.train import diffusion_terms as j_diffusion_terms
from qcpinn_tpu.train import inject_balancer_params as j_inject
from qcpinn_tpu.train import make_train_step as j_make_train_step
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu.train import train as j_train
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax, params_to_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.models import ClassicalSolver as TClassical
from qcpinn_tpu_torch.models import DVSolver as TDV
from qcpinn_tpu_torch.physics import diffusion_operator, get_operator as t_get_operator
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train.loop import TermSpec as TTerm
from qcpinn_tpu_torch.train.loop import (diffusion_terms, inject_balancer_params,
                                         make_train_step, make_val_fn, train)
from qcpinn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

NET = (3, 6, 1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(solver, params=None):
    kw = dict(solver=solver, classic_network=NET, num_qubits=2, q_ansatz="cascade",
              seed=5)
    jm = (JDV if solver == "DV" else JClassical)(JConfig(**kw))
    if params is None:
        params = jm.init(jax.random.PRNGKey(2))
    tm = (TDV if solver == "DV" else TClassical)(TConfig(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, tm


class _Fixed:
    """A sampler that returns preset points (the same in both packages)."""

    def __init__(self, X, func, to):
        self.X, self.func, self.to = X, func, to

    def sample(self, _key, n):
        X = self.to(self.X[:n])
        return X, self.func(X)


def _terms(jax_side: bool, b: int = 9):
    """The canonical diffusion terms (residual on the reference forcing,
    BC1 and IC) on fixed points."""
    rng = np.random.default_rng(11)
    X = {"res": rng.uniform(size=(b, 3)), "bc1": rng.uniform(size=(b // 3, 3)),
         "ics": rng.uniform(size=(b // 3, 3))}
    X["bc1"][:, 1] = 0.0
    X["ics"][:, 0] = 0.0
    X = {k: v.astype(np.float32) for k, v in X.items()}
    to = jnp.asarray if jax_side else torch.tensor
    dd = jdd if jax_side else tdd
    samplers = {"res": _Fixed(X["res"], dd.r, to), "bc1": _Fixed(X["bc1"], dd.u, to),
                "ics": _Fixed(X["ics"], dd.u, to)}
    return (j_diffusion_terms if jax_side else diffusion_terms)(samplers, b)


def _op_mode(solver):
    return "rev" if solver == "Classical" else "fwd"


def _assert_tree_close(got, want, rtol=2e-4):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np(want))
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        scale = max(float(np.max(np.abs(np.asarray(w)))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(w), atol=rtol * scale)


def test_diffusion_terms_match_jax():
    got = diffusion_terms(tdd.gaussian_pulse_samplers(), 64)
    want = j_diffusion_terms(jdd.gaussian_pulse_samplers(), 64)
    assert list(got) == list(want) == ["res", "bc", "ic"]
    for k in want:
        assert (got[k].weight, got[k].batch, got[k].kind) == (
            want[k].weight, want[k].batch, want[k].kind)
        np.testing.assert_array_equal(got[k].sampler.coords, want[k].sampler.coords)
    assert got["res"].sampler.func is tdd.r  # the reference forcing, defect kept


@pytest.mark.parametrize("solver,balancer", [
    ("Classical", "none"), ("Classical", "ema"), ("Classical", "uncertainty"),
    ("DV", "ema"), ("DV", "uncertainty")])
def test_one_step_per_balancer_matches_jax(solver, balancer):
    """One make_train_step step: loss rtol 2e-5, every grad (the
    log-variances' too) within 2e-4 * max(|ref|, 1e-3), and the EMA state
    the step leaves behind. The DV model fuses its value terms, the
    Hopfield model does not (it couples the batch)."""
    jm, params, tm = _models(solver)
    fuse = solver == "DV"
    jterms, tterms = _terms(True), _terms(False)
    jcfg, tcfg = JConfig(solver=solver), TConfig(solver=solver)
    params = j_inject(params, jterms, balancer)
    if balancer == "ema":  # start the EMA away from its init of ones
        params["loss_ema"] = {k: jnp.float32(v) for k, v in
                              zip(jterms, (0.5, 2.0, 1.5))}
    inject_balancer_params(tm, tterms, balancer)
    tm.load_state_dict(params_from_jax(_np(params)))
    captured = {}

    def j_update(grads, state, params=None):
        captured["g"] = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), state

    jo = optax.GradientTransformation(lambda p: optax.EmptyState(), j_update)
    j_step, _ = j_make_train_step(jm.apply, j_get_operator("diffusion", _op_mode(solver)),
                                  jterms, jo, jcfg, fuse_value_terms=fuse,
                                  balancer=balancer)
    (j_params, _, _), jm_ = j_step((params, jo.init(params), jopt.plateau_init()),
                                   (jax.random.PRNGKey(0), jnp.int32(0)))

    def t_update(grads, state, params):
        captured["t"] = grads
        return [torch.zeros_like(g) for g in grads], state

    to = topt.GradientTransformation(lambda p: None, t_update)
    t_step, _ = make_train_step(tm, t_get_operator("diffusion", _op_mode(solver)), tterms,
                                to, tcfg, fuse_value_terms=fuse, balancer=balancer)
    tparams = [p for p in tm.parameters() if p.requires_grad]
    _, _, tm_ = t_step(tparams, None, topt.plateau_init(), torch.Generator())
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=2e-5)
    for k in jterms:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=2e-5)
    for p, g in zip(tparams, captured["t"]):
        p.grad = g
    _assert_tree_close(grads_to_jax_layout(tm), captured["g"])
    if balancer == "ema":
        for k, v in j_params["loss_ema"].items():
            np.testing.assert_allclose(float(tm.loss_ema.as_dict()[k]), float(v), rtol=1e-6)
    if balancer == "uncertainty":
        assert set(dict(tm.named_parameters())) >= {f"loss_log_vars.{k}" for k in tterms}


def test_weight_decay_matches_optax():
    """Three clipped steps of the chain with coupled decay: grad + wd * param
    after the clip, before Adam's moments."""
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    grads = [[s * rng.normal(size=a.shape).astype(np.float32) for a in p0]
             for s in (3.0, 0.1, 1.5)]
    kw = dict(grad_clip=1.0, schedule="plateau", epochs=4, weight_decay=0.05)
    jo, to = jopt.make_optimizer(5e-3, **kw), topt.make_optimizer(5e-3, **kw)
    jp, tp = [jnp.asarray(a) for a in p0], [torch.tensor(a) for a in p0]
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        upd, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = to.update([torch.tensor(a) for a in g], ts, tp)
        topt.apply_updates(tp, tu)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _cfg(cls, solver, **kw):
    return cls(solver=solver, classic_network=NET, num_qubits=2, q_ansatz="cascade",
               seed=5, **kw)


@pytest.mark.parametrize("solver,balancer", [("Classical", "uncertainty"), ("DV", "ema")])
def test_five_train_steps_match_jax(solver, balancer):
    """``train()`` in both packages from the same initial weights on fixed
    points: each step's loss rtol 1e-4, the final parameters within 2e-4 *
    scale, weight decay on."""
    kw = dict(epochs=5, print_every=5, loss_balancer=balancer, weight_decay=1e-3)
    jcfg, tcfg = _cfg(JConfig, solver, **kw), _cfg(TConfig, solver, **kw)
    jm = (JDV if solver == "DV" else JClassical)(jcfg)
    k_init, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    _, _, tm = _models(solver, jm.init(k_init))
    j_params, j_hist = j_train(jm, jcfg, _terms(True),
                               j_get_operator("diffusion", _op_mode(solver)))
    tm, t_hist = train(tm, tcfg, _terms(False),
                       t_get_operator("diffusion", _op_mode(solver)), device="cpu")
    assert len(t_hist) == len(j_hist) == 5
    np.testing.assert_allclose(t_hist, j_hist, rtol=1e-4)
    _assert_tree_close(params_to_jax(tm), j_params)


class _Log:
    def __init__(self):
        self.lines = []

    def print(self, msg):
        self.lines.append(msg)


def test_best_val_restores_the_best_chunk():
    """val_fn after every chunk; the parameters of the lowest value come
    back at the end, and the log lines keep the JAX format."""
    _, _, tm = _models("Classical")
    cfg = _cfg(TConfig, "Classical", epochs=6, print_every=2)
    seen, values = [], iter([3.0, 1.0, 2.0])

    def val_fn():
        seen.append({k: v.clone() for k, v in tm.state_dict().items()})
        return torch.tensor(next(values))

    log = _Log()
    tm, hist = train(tm, cfg, _terms(False), t_get_operator("diffusion", "rev"),
                     logger=log, val_fn=val_fn, device="cpu")
    assert len(hist) == 6 and len(seen) == 3
    assert not torch.equal(seen[1]["pre.weight"], seen[2]["pre.weight"])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, seen[1][k]), k
    epochs = [line for line in log.lines if line.startswith("Epoch: ")]
    assert epochs[0].startswith("Epoch: 2/6 | Loss: ")
    assert "| res: " in epochs[0] and "| lr_scale: 1.00e+00 | val: 3.00e+00 (best)" in epochs[0]
    assert "| val: 2.00e+00 (best 1.00e+00) | Total: " in epochs[2] and "| ETA: " in epochs[2]
    assert log.lines[-1] == "restoring best-validation params (val=1.00e+00)"
    X = torch.rand(5, 3)
    v = make_val_fn(tm, X, torch.zeros(5, 1))()
    torch.testing.assert_close(v, torch.mean(tm(X).detach() ** 2))


@pytest.mark.parametrize("balancer", ["ema", "uncertainty"])
def test_resume_continues_bit_equal(balancer, tmp_path):
    """Four steps in one run equal two steps, a checkpoint, and two more
    steps resumed from it in a fresh model: parameters, balancer state,
    optimizer and plateau state and the sample stream (real samplers)."""
    cfg = _cfg(TConfig, "Classical", epochs=4, print_every=2, loss_balancer=balancer)
    terms = diffusion_terms(tdd.gaussian_pulse_samplers(), 9)
    op = t_get_operator("diffusion", "rev")
    path = str(tmp_path / "ckpt")

    def save_at_2(model, stage, step, history):
        if step == 2:
            save_checkpoint(path, model, opt_state=stage.opt_state, sched=stage.sched,
                            rng=stage.gen.get_state(), loss_history=history, epoch=step)

    full, hist = train(TClassical(cfg, device="cpu"), cfg, terms, op,
                       checkpoint_fn=save_at_2, device="cpu")
    fresh = inject_balancer_params(TClassical(cfg, device="cpu"), terms, balancer)
    ck = load_checkpoint(path, fresh)
    assert ck["epoch"] == 2 and ck["loss_history"] == hist[:2]
    resumed, hist2 = train(fresh, cfg, terms, op, device="cpu",
                           resume={**ck["bundle"], "step": ck["epoch"]})
    assert hist2 == hist[2:]
    sd, sd2 = full.state_dict(), resumed.state_dict()
    assert set(sd) == set(sd2) and any(k.startswith("loss_") for k in sd)
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k


def test_readme_library_form(capsys):
    """``train(model, cfg, diffusion_terms(gaussian_pulse_samplers(), ...),
    diffusion_operator)`` as README.md's library example, the reverse-mode
    operator through the DV circuit; shots are logged as ignored."""
    from qcpinn_tpu_torch.data import gaussian_pulse_samplers
    from qcpinn_tpu_torch.utils.logger import Logging

    cfg = TConfig(num_qubits=2, q_ansatz="cascade", classic_network=(3, 4, 1), epochs=2,
                  batch_size=6, shots=100)
    model = TDV(cfg, device="cpu")
    log = _Log()
    model, history = train(model, cfg, diffusion_terms(gaussian_pulse_samplers(), cfg.batch_size),
                           diffusion_operator, logger=log, device="cpu")
    assert len(history) == 2 and np.isfinite(history).all()
    assert any(line.startswith("shots=100 ignored: backprop mode") for line in log.lines)
    assert Logging  # the run-directory logger is what the CLI passes


def test_unported_modes_raise():
    cfg = TConfig(num_qubits=2, classic_network=(3, 4, 1), epochs=1, batch_size=6)
    terms = diffusion_terms(tdd.gaussian_pulse_samplers(), 6)
    with pytest.raises(ValueError, match="needs quantum parameters"):
        train(TClassical(TConfig(solver="Classical", classic_network=(3, 4, 1)), device="cpu"),
              TConfig(solver="Classical", gradient_mode="spsa-split", epochs=1), terms,
              diffusion_operator, device="cpu")
    with pytest.raises(ValueError, match="needs a solver with a hardware apply"):
        train(TClassical(TConfig(solver="Classical", classic_network=(3, 4, 1)), device="cpu"),
              TConfig(solver="Classical", gradient_mode="parameter-shift", epochs=1), terms,
              diffusion_operator, device="cpu")
    # mesh=, ported: a world of one trains the single-device trajectory
    import torch.distributed as dist

    from qcpinn_tpu_torch.parallel import make_mesh

    cfg2 = TConfig(num_qubits=2, classic_network=(3, 4, 1), epochs=2, batch_size=6)
    _, want = train(TDV(cfg2, device="cpu"), cfg2, terms, diffusion_operator, device="cpu")
    try:
        _, got = train(TDV(cfg2, device="cpu"), cfg2, terms, diffusion_operator,
                       mesh=make_mesh(device="cpu"), device="cpu")
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="inject_balancer_params"):
        make_train_step(TDV(cfg, device="cpu"), diffusion_operator, terms,
                        topt.make_optimizer(1e-3), cfg, balancer="ema")
    with pytest.raises(ValueError, match="train on"):
        train(TDV(cfg, device="cpu"), cfg, terms, diffusion_operator, device="meta")
    assert TTerm is not None and JTerm is not None


def test_mse_at_time_slice_matches_jax():
    """The MSE on the t = 0.5 spatial grid (JAX's utils.mse_at_time_slice),
    the same weights in both packages: rtol 1e-5."""
    from qcpinn_tpu.utils import mse_at_time_slice as j_mse
    from qcpinn_tpu_torch.utils import mse_at_time_slice

    jm, params, tm = _models("Classical")
    for t, num in ((0.5, 6), (0.2, 4)):
        want = j_mse(jm.apply, params, jdd.u, t=t, num=num)
        got = mse_at_time_slice(tm, tdd.u, t=t, num=num, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_profile_hook_writes_a_trace(monkeypatch, tmp_path):
    """QCPINN_PROFILE_DIR (JAX's jax.profiler hook of train()): the loop runs
    under torch.profiler and one Chrome trace is written there; unset, none."""
    import json as _json
    import os

    cfg = _cfg(TConfig, "Classical", epochs=2, print_every=1)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("QCPINN_PROFILE_DIR", str(trace_dir))
    log = _Log()
    train(TClassical(cfg, device="cpu"), cfg, _terms(False), t_get_operator("diffusion", "rev"),
          logger=log, device="cpu")
    (name,) = os.listdir(trace_dir)
    assert name.startswith("train-") and name.endswith(".pt.trace.json")
    with open(trace_dir / name) as f:
        assert _json.load(f)["traceEvents"]
    assert log.lines[-1] == f"profiler trace written to {trace_dir}"
    monkeypatch.delenv("QCPINN_PROFILE_DIR")
    log = _Log()
    train(TClassical(cfg, device="cpu"), cfg, _terms(False), t_get_operator("diffusion", "rev"),
          logger=log, device="cpu")
    assert not any("profiler" in line for line in log.lines)


def test_profile_hook_of_cz_pretrain_writes_a_trace_and_its_spans(monkeypatch, tmp_path):
    """``cz_pipeline.run_pretrain`` honours QCPINN_PROFILE_DIR as train()
    does, with spans on for the epochs: the Chrome trace holds the qc:: host
    and device spans, and the spans' summary of the last step (device ms,
    self ms, rows, count, and the edges in order) is written beside it; the
    spans are off again afterwards."""
    import json as _json
    import os

    from qcpinn_tpu_torch.data.cz_loader import DataStats
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from qcpinn_tpu_torch.train import cz_pipeline as czp
    from qcpinn_tpu_torch.utils import spans

    rng = np.random.default_rng(0)
    X = rng.uniform(0.05, 1, (16, 2)).astype(np.float32)
    Y = rng.uniform(-0.5, 0.5, (16, 5)).astype(np.float32)
    stats = DataStats(length_scale=1.0, velocity_scale=1.0, pressure_scale=1.0,
                      temp_min=0.0, temp_max=1.0, pressure_coeff=3.0)
    cfg = czp.CzConfig(n_qubits=2, n_layers=1, epochs=1, batch_size=8, physics_warmup=0)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("QCPINN_PROFILE_DIR", str(trace_dir))
    log = _Log()
    czp.run_pretrain(Hybrid16QPINN(2, 1, width=4, remat=False, device="cpu"), X, Y, stats,
                     cfg, logger=log)
    assert not spans.enabled()
    summary_name, trace_name = sorted(os.listdir(trace_dir))
    assert summary_name.startswith("spans-") and trace_name.startswith("train-")
    with open(trace_dir / summary_name) as f:
        summary = _json.load(f)
    assert set(summary["spans"]) == {"step", "data_forward", "residual", "engine", "backward",
                                     "engine.bwd", "optimizer"}
    # the residual on the model's jet: the data forward's engine call and
    # the jet's
    assert log.lines.count("residual path: jet") == 1
    assert summary["spans"]["engine"]["count"] == 2
    assert summary["spans"]["step"]["rows"] == 8 and summary["spans"]["step"]["ms"] > 0
    assert summary["edges"][0] == ["step", "begin"] and summary["edges"][-1] == ["step", "end"]
    with open(trace_dir / trace_name) as f:
        names = {e.get("name") for e in _json.load(f)["traceEvents"]}
    assert {"qc::shuffle", "qc::feed", "qc::step", "qc::engine.bwd"} <= names
    assert log.lines[-1] == f"profiler trace written to {trace_dir}"


def test_captured_step_holds_its_owner_weakly():
    """A CapturedStep built on its owner's method (PretrainEpoch,
    FinetuneStep, CrystalTrainer) makes no reference cycle: the owner, and
    with it the graph and its memory pool, goes with its last reference,
    without Python's cycle collector. A closure is held as given."""
    import gc
    import weakref

    from qcpinn_tpu_torch.train.loop import CapturedStep

    class Owner:
        def __init__(self):
            self.captured = CapturedStep(self.step)

        def step(self):
            return torch.ones(())

    owner = Owner()
    captured = owner.captured
    assert float(captured.step()) == 1.0
    ref = weakref.ref(owner)
    gc.disable()
    try:
        del owner
        assert ref() is None
    finally:
        gc.enable()
    with pytest.raises(ReferenceError, match="is gone"):
        captured.step()
    closure = CapturedStep(lambda: torch.zeros(()))
    assert float(closure.step()) == 0.0
