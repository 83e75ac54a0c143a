"""The port's Czochralski pipeline (qcpinn_tpu_torch/train/cz_pipeline.py)
against the JAX package's: one pretrain step in each physics_normalize mode
and in the data-only mode, a deterministic full-scope finetune, and the
pipeline's behaviour (field weights, the balancer leaf stripped, the time
budget, the rotating shuffle tail, the warm start, the finetune scopes,
the chunked forward-mode residual under remat)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.data.cz_loader import DataStats as JStats
from qcpinn_tpu.models.czochralski import Hybrid16QPINN as JModel
from qcpinn_tpu.train import cz_pipeline as jp
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax, params_to_jax
from qcpinn_tpu_torch.data.cz_loader import DataStats
from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
from qcpinn_tpu_torch.train import cz_pipeline as tp
from qcpinn_tpu_torch.train import optim as topt

STATS = dict(length_scale=1.0, velocity_scale=1.0, pressure_scale=1.0, temp_min=0.0,
             temp_max=1.0, pressure_coeff=3.0)


def _data(rows, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 1, (rows, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (rows, 5)).astype(np.float32))


def _model(tree=None, n=2, width=4, L=1, seed=0):
    m = Hybrid16QPINN(n, L, width=width, remat=False, seed=seed, device="cpu")
    if tree is not None:
        m.load_state_dict(params_from_jax(tree))
    return m


def _leaves_close(got: dict, want: dict, tol):
    """Every leaf of ``got`` within ``tol`` x the largest |leaf| of
    ``want``."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    scale = max(float(np.abs(np.asarray(b)).max()) for b in w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol * scale)


def _grads_close(model, grads, want: dict, tol=2e-4):
    """The gradients ``grads`` of ``model``'s trainable tensors, in the JAX
    tree's layout (zero for a buffer, as JAX's stop_gradient gives it),
    leaf by leaf within ``tol`` x the largest |leaf| of ``want``."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p, g in zip(params, grads):
        p.grad = g.detach()
    got = grads_to_jax_layout(model)
    for p in params:
        p.grad = None
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.abs(b).max()))


@pytest.mark.parametrize("norm,weight", [("reference", 0.05), ("balanced", 0.05),
                                         ("coupled", 0.05), ("reference", 0.0)])
def test_pretrain_step_matches_jax(norm, weight):
    """One step from shared params on one batch (JAX's epoch of a single
    batch, its rows in JAX's shuffled order) against the port's
    ``step_fn``, physics engaged (warmup 0, ramp 1) or the data-only mode
    (weight 0): loss rtol 2e-5; the EMA state rtol 1e-4; the gradients
    before the step, as JAX's Adam receives them (clipped by global norm
    1.0: its first moment after one step over 1 - b1), each leaf within
    2e-4 x max|ref| of that leaf; params after the step within 2e-4 x the
    largest |param|. (Adam's first update is lr g / (|g| + eps): the
    to_quantum biases' gradients sit near eps at this size, so a leafwise
    scale on the parameters would read float noise in g as error; the
    gradients themselves are held leaf by leaf.)"""
    b = 8
    X, Y = _data(b)
    cfg = dict(n_qubits=3, n_layers=1, epochs=4, batch_size=b, physics_weight=weight,
               physics_warmup=0, physics_ramp=1, physics_normalize=norm, seed=0)
    jm = JModel(3, 1, width=4, remat=False)
    params = jm.init(jax.random.PRNGKey(3))
    tm = _model(n=3)
    if norm == "coupled":
        from qcpinn_tpu.models.si_gated import coupled_weighting_init as j_init
        from qcpinn_tpu_torch.models.si_gated import coupled_weighting_init

        params = {**params, "loss_bal": j_init()}
        tm.loss_bal = coupled_weighting_init()
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    opt, epoch_fn, _ = jp.make_pretrain_epoch(jm, X, Y, JStats(**STATS), jp.CzConfig(**cfg))
    ema = {k: jnp.asarray(1.0) for k in tp.EMA_KEYS}
    key = jax.random.PRNGKey(0)
    want, want_opt, want_ema, m = epoch_fn(params, opt.init(params), ema,
                                           jnp.asarray(1.0, jnp.float32), key)
    (adam_state,) = [st for st in want_opt if hasattr(st, "mu")]
    want_grads = jax.tree_util.tree_map(lambda v: np.asarray(v) / (1.0 - topt.B1),
                                        adam_state.mu)

    ep = tp.make_pretrain_epoch(tm, X, Y, DataStats(**STATS), tp.CzConfig(**cfg))
    assert ep.n_batches == 1 and ep.data_only == (weight == 0.0)
    perm = np.asarray(jax.random.permutation(key, b))
    xb, yb = torch.tensor(X[perm]), torch.tensor(Y[perm])
    phys_w = tp._phys_weight(ep.cfg, 1.0)
    total = ep.batch_loss(xb, yb, phys_w)[0]
    grads = torch.autograd.grad(total, ep.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ep.params, grads)]
    _grads_close(tm, topt.clip_grads(grads, 1.0)[0], want_grads)
    out = ep.step_fn(xb, yb, phys_w, tp._cosine_lr(ep.cfg.lr, 1.0, ep.cfg.epochs))
    np.testing.assert_allclose(float(out[0]), float(m["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(out[1]), float(m["data"]), rtol=2e-5)
    np.testing.assert_allclose(float(out[2]), float(m["phys"]), rtol=2e-5, atol=1e-30)
    for k in tp.EMA_KEYS:
        np.testing.assert_allclose(float(ep.ema[k]), float(want_ema[k]), rtol=1e-4)
    _leaves_close(params_to_jax(tm), jax.tree_util.tree_map(np.asarray, want), 2e-4)


def test_epoch_lr_and_phys_weight_match_jax():
    cfg = tp.CzConfig(epochs=300, physics_warmup=25, physics_ramp=60, lr=1e-3)
    for e in (1, 25, 26, 50, 85, 86, 150, 300):
        assert tp._phys_weight(cfg, e) == pytest.approx(
            0.05 * min(max((e - 25) / 60, 0.0), 1.0), rel=1e-6)
        np.testing.assert_allclose(tp._cosine_lr(1e-3, e, 300),
                                   float(jp._cosine_lr(1e-3, float(e), 300)), rtol=1e-6)


def test_field_weights_match_jax_and_reject_bad_values():
    w = (1.0, 2.0, 3.0, 0.5, 0.0)
    np.testing.assert_allclose(tp.CzConfig(field_weights=w).norm_field_weights().numpy(),
                               np.asarray(jp.CzConfig(field_weights=w).norm_field_weights()),
                               rtol=1e-6)
    assert tp.CzConfig().norm_field_weights() is None
    with pytest.raises(ValueError, match="non-negative"):
        tp.CzConfig(field_weights=(1.0, 1.0, -2.0, 0.0, 0.0)).norm_field_weights()
    with pytest.raises(ValueError, match="positive sum"):
        tp.CzConfig(field_weights=(0.0,) * 5).norm_field_weights()
    with pytest.raises(ValueError, match="5 values"):
        tp.CzConfig(field_weights=(1.0,) * 4).norm_field_weights()
    assert tp.CzConfig(batch_size=256).effective_remat is False
    assert tp.CzConfig(batch_size=512).effective_remat is True
    assert tp.CzConfig(batch_size=512, remat=False).effective_remat is False


def test_field_weights_scale_the_data_loss():
    X, Y = _data(8)
    cfg = tp.CzConfig(n_qubits=2, n_layers=1, batch_size=8, physics_weight=0.0,
                      field_weights=(1.0, 0.0, 0.0, 0.0, 4.0))
    m = _model()
    ep = tp.make_pretrain_epoch(m, X, Y, DataStats(**STATS), cfg)
    with torch.no_grad():
        sq = (m(torch.tensor(X)) - torch.tensor(Y)) ** 2
    want = torch.mean(sq * torch.tensor([1.0, 0, 0, 0, 4.0]))  # mean 1 already
    out = ep.step_fn(torch.tensor(X), torch.tensor(Y), 0.0, 1e-3)
    np.testing.assert_allclose(float(out[1]), float(want), rtol=1e-6)


def test_coupled_balancer_is_stripped_and_time_budget_stops():
    """The coupled leaf trains but never reaches a checkpoint; a budget
    crossed in epoch 1 stops the run there; the balanced warning."""
    X, Y = _data(24)
    seen, logs = [], []

    class Log:
        def print(self, msg):
            logs.append(msg)

    cfg = tp.CzConfig(n_qubits=2, n_layers=1, epochs=3, batch_size=8, physics_warmup=0,
                      physics_ramp=1, physics_normalize="coupled", log_every=1)
    m, hist = tp.run_pretrain(_model(), X, Y, DataStats(**STATS), cfg, logger=Log(),
                              checkpoint_fn=lambda p, e, h: seen.append((sorted(p), e, list(h))),
                              save_every=1)
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert not hasattr(m, "loss_bal")
    assert [e for _, e, _ in seen] == [1, 2, 3]
    assert all("loss_bal" not in keys for keys, _, _ in seen)
    assert any("coupled adaptive weighting on" in line for line in logs)
    assert sum(line.startswith("[PRETRAIN] epoch") for line in logs) == 3

    logs.clear()
    cfg = tp.CzConfig(n_qubits=2, n_layers=1, epochs=5, batch_size=8, physics_warmup=0,
                      physics_normalize="balanced")
    _, hist = tp.run_pretrain(_model(), X, Y, DataStats(**STATS), cfg, logger=Log(),
                              time_budget_s=1e-9)
    assert len(hist) == 1
    assert any("time budget" in line and "epoch 1/5" in line for line in logs)
    assert any(line.startswith("WARNING: physics_normalize='balanced'") for line in logs)


def test_shuffle_drops_a_rotating_tail():
    """Each epoch permutes all rows and drops the remainder after the
    shuffle: every row is seen over a few epochs, the dropped rows change."""
    X, Y = _data(10)
    X[:, 0] = np.arange(10, dtype=np.float32)  # the row's id in r
    cfg = tp.CzConfig(n_qubits=2, n_layers=1, epochs=6, batch_size=4)
    ep = tp.make_pretrain_epoch(_model(), X, Y, DataStats(**STATS), cfg)
    batches = []
    ep._step = lambda: (batches.append(ep.xb[:, 0].clone()), torch.zeros(3))[1]
    gen = torch.Generator().manual_seed(0)
    used = []
    for e in range(1, 7):
        batches.clear()
        ep(e, gen)
        rows = torch.cat(batches).long().tolist()
        assert len(rows) == 8 and len(set(rows)) == 8
        used.append(frozenset(rows))
    assert set().union(*used) == set(range(10))
    assert len({frozenset(range(10)) - u for u in used}) > 1


def test_pretrain_epoch_and_finetune_step_go_with_their_last_reference():
    """No reference cycle holds a PretrainEpoch or a FinetuneStep: on the
    card each owns a CapturedStep whose graph and memory pool go with it,
    by reference counts alone, without Python's cycle collector."""
    import gc
    import weakref

    X, Y = _data(8)
    cfg = tp.CzConfig(n_qubits=2, n_layers=1, epochs=1, batch_size=4, calib_size=4,
                      shots=16)
    ep = tp.make_pretrain_epoch(_model(), X, Y, DataStats(**STATS), cfg)
    ep(1, torch.Generator().manual_seed(0))
    ft = tp.FinetuneStep(_model(), X, Y, cfg, torch.Generator().manual_seed(1))
    ft.run()
    refs = [weakref.ref(ep), weakref.ref(ft)]
    gc.disable()
    try:
        del ep, ft
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_warm_start_and_fresh_init():
    X, Y = _data(8)
    cfg = tp.CzConfig(n_qubits=2, n_layers=1, epochs=0, batch_size=8, seed=5)
    tree = params_to_jax(_model(seed=9))
    m, hist = tp.run_pretrain(_model(), X, Y, DataStats(**STATS), cfg, params=tree)
    assert hist == []
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(m)), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    m, _ = tp.run_pretrain(_model(), X, Y, DataStats(**STATS), cfg)
    fresh = _model(seed=5)
    for (k, a), b in zip(m.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("path", ["jvp", "jet"])
def test_chunked_residual_under_remat_gives_the_same_step(monkeypatch, path):
    """remat with the forward-mode residual gives the step of the whole
    batch: on the nested jvps (forced) the residual and its gradient in
    chunks of rows; on the jet, in one piece through the circuit's
    checkpointed segments."""
    from qcpinn_tpu_torch.physics.operators_fwd import cz_residuals_fwd

    monkeypatch.setattr(tp, "REMAT_ROWS", 3)
    X, Y = _data(8)
    base = dict(n_qubits=2, n_layers=1, batch_size=8, physics_warmup=0, physics_ramp=1,
                physics_normalize="balanced")
    outs, models = [], []
    for remat in (False, True):
        m = _model(seed=2)
        ep = tp.make_pretrain_epoch(m, X, Y, DataStats(**STATS), tp.CzConfig(**base, remat=remat))
        if path == "jvp":
            ep.residual_fn = cz_residuals_fwd
        assert ep.residual_path == path
        assert (ep.chunk_rows is not None) == (remat and path == "jvp")
        outs.append(ep.step_fn(torch.tensor(X), torch.tensor(Y), 0.05, 1e-3))
        models.append(m)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=0)
    scale = max(float(p.abs().max()) for p in models[0].parameters())
    for a, b in zip(models[1].parameters(), models[0].parameters()):
        assert float((a - b).abs().max()) <= 2e-4 * scale


def test_full_scope_finetune_matches_jax():
    """Exact readout (shots=None), full scope: the parameter-shift backward
    and Adam at finetune_lr, 2 epochs, against JAX's run_finetune: the
    gradients of the first step's loss (JAX's loss of run_finetune on the
    calibration subset, its parameter-shift apply) each leaf within 2e-4 x
    max|ref| of that leaf; the loss history rtol 1e-4, the params after
    within 2e-4 x the largest |param|."""
    from qcpinn_tpu.data.cz_loader import choose_calibration_subset
    from qcpinn_tpu.ops.measure import NoiseModel
    from qcpinn_tpu.train.hardware_grad import make_hw_apply_cz

    X, Y = _data(30, seed=1)
    cfg = dict(n_qubits=3, n_layers=1, finetune_epochs=2, calib_size=4, shots=None,
               train_scope="full", finetune_lr=1e-2, noise_readout=0.02)
    jm = JModel(3, 1, width=4, remat=False)
    params = jm.init(jax.random.PRNGKey(4))
    x_c, y_c = choose_calibration_subset(X, Y, cfg["calib_size"])
    noise = NoiseModel(0.0, cfg["noise_readout"], 0.0)
    q_apply = make_hw_apply_cz(jm.q, None, noise=noise)

    def j_loss(p):
        pred = jm.apply(p, jnp.asarray(x_c), shots=None, key=jax.random.PRNGKey(0),
                        noise=noise, detach_quantum=False, q_apply=q_apply)
        return jnp.mean((pred - jnp.asarray(y_c)) ** 2)

    want_grads = jax.tree_util.tree_map(np.asarray, jax.grad(j_loss)(params))
    tree = jax.tree_util.tree_map(np.asarray, params)
    first = _model(tree, n=3)
    ft = tp.FinetuneStep(first, X, Y, tp.CzConfig(**cfg), torch.Generator())
    loss = ft.loss()
    np.testing.assert_allclose(float(loss), float(j_loss(params)), rtol=2e-5)
    _grads_close(first, torch.autograd.grad(loss, ft.params), want_grads)
    want, jhist = jp.run_finetune(jm, params, X, Y, JStats(**STATS), jp.CzConfig(**cfg),
                                  logger=type("L", (), {"print": lambda self, m: None})())
    m, hist = tp.run_finetune(_model(n=3), tree, X, Y, DataStats(**STATS), tp.CzConfig(**cfg),
                              logger=type("L", (), {"print": lambda self, m: None})())
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    _leaves_close(params_to_jax(m), jax.tree_util.tree_map(np.asarray, want), 2e-4)


@pytest.mark.parametrize("scope", ["head", "full"])
def test_finetune_scopes(scope):
    """Head scope moves only ``post``; full scope moves the circuit's
    weights and the trunk too. Shot-sampled, with the ft_noise record's
    noise; the budget line counts the scope's evaluations a step."""
    X, Y = _data(30, seed=2)
    m = _model(n=3, width=4, L=2)
    before = {k: p.detach().clone() for k, p in m.named_parameters()}
    logs = []
    cfg = tp.CzConfig(n_qubits=3, n_layers=2, finetune_epochs=2, calib_size=4, shots=64,
                      train_scope=scope, finetune_lr=1e-2, noise_readout=0.01,
                      noise_per_gate=0.001)
    m, hist = tp.run_finetune(m, None, X, Y, DataStats(**STATS), cfg,
                              logger=type("L", (), {"print": lambda self, s: logs.append(s)})())
    assert len(hist) == 2 and all(np.isfinite(hist))
    moved = {k.split(".")[0] for k, p in m.named_parameters() if not torch.equal(p, before[k])}
    if scope == "head":
        assert moved == {"post"}
        assert "x 1 evals/step x 4 samples x 64 shots (scope=head)" in logs[0]
    else:
        assert {"post", "q", "to_quantum", "coord_proj"} <= moved
        assert "x 55 evals/step x 4 samples x 64 shots (scope=full)" in logs[0]
    with pytest.raises(ValueError, match="unsupported train_scope"):
        tp.run_finetune(m, None, X, Y, DataStats(**STATS),
                        tp.CzConfig(n_qubits=3, n_layers=2, train_scope="trunk"))


# -- the pipeline on a ('data', 'amp') = (2, 2) gloo world of 4 CPU processes
# (torch_parallel_worker.cz_cases): the amp-sharded model against JAX's
# apply and gradients, the data-parallel pretrain, the sharded full-scope
# finetune and the evaluation over the mesh against single-device runs

CZ_FORWARD = dict(n=5, L=1, width=8)  # a wire group split: sharded and local wires
CZ_RUNS = dict(n=3, L=1, width=8)  # a group over every wire


def _quiet():
    return type("L", (), {"print": lambda self, m: None})()


@pytest.fixture(scope="module")
def cz_world():
    from torch_parallel_worker import cz_cases, start_world

    jm = JModel(CZ_FORWARD["n"], CZ_FORWARD["L"], width=CZ_FORWARD["width"], remat=False)
    fwd_params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    run_params = jax.tree_util.tree_map(np.asarray, JModel(
        CZ_RUNS["n"], CZ_RUNS["L"], width=CZ_RUNS["width"], remat=False).init(
            jax.random.PRNGKey(5)))
    X, Y = _data(64, seed=3)
    pre = dict(n_qubits=3, n_layers=1, epochs=2, batch_size=16, physics_warmup=0,
               physics_ramp=1, physics_normalize="balanced", log_every=1)
    ft = dict(n_qubits=3, n_layers=1, finetune_epochs=2, calib_size=4, shots=64,
              train_scope="full", finetune_lr=1e-2, noise_readout=0.02)
    payload = {
        "data": 2, "amp": 2,
        "forward": dict(**CZ_FORWARD, params=fwd_params, x=X[:12]),
        "pretrain": dict(**CZ_RUNS, params=run_params, cfg=pre, stats=STATS, X=X, Y=Y),
        "finetune": dict(**CZ_RUNS, params=run_params, cfg=ft, stats=STATS, X=X, Y=Y),
        "eval": dict(**CZ_RUNS, params=run_params, X=X[:40], Y=Y[:40], batch=16),
    }
    future = start_world(4, cz_cases, payload)

    def j_loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(X[:12])) ** 2)

    refs = {"forward": np.asarray(jax.jit(jm.apply)(fwd_params, jnp.asarray(X[:12]))),
            "forward_grads": jax.tree_util.tree_map(
                np.asarray, jax.jit(jax.grad(j_loss))(fwd_params))}
    return payload, refs, future.result()


def test_use_sharded_matches_jax(cz_world):
    """``Hybrid16QPINN.use_sharded`` at data 2 x amp 2: the forward within
    5e-5 of JAX's apply, the gradients of sum(pred^2) within 2e-4 x
    max|ref| of each leaf (its wire group 0 split between a sharded wire and
    three local ones)."""
    _, refs, res = cz_world
    for r in res:
        np.testing.assert_allclose(r["forward"], refs["forward"], atol=5e-5)
        got = jax.tree_util.tree_leaves(r["forward_grads"])
        want = jax.tree_util.tree_leaves(refs["forward_grads"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=2e-4 * max(np.abs(b).max(), 1e-6))


def _single(c, sharded_cfg):
    m = Hybrid16QPINN(c["n"], c["L"], width=c["width"], remat=False, device="cpu")
    m.load_state_dict(params_from_jax(c["params"]))
    return m, tp.CzConfig(**sharded_cfg)


def test_data_parallel_pretrain_matches_single_device(cz_world):
    """The data-parallel, amp-sharded pretrain follows the single-device
    history (rtol 1e-4 / atol 1e-6, JAX's own limit), the shuffle alike on
    every rank; a batch that does not split over 'data' raises JAX's
    error."""
    payload, _, res = cz_world
    c = payload["pretrain"]
    m, cfg = _single(c, c["cfg"])
    _, want = tp.run_pretrain(m, c["X"], c["Y"], DataStats(**STATS), cfg, logger=_quiet(),
                              params=c["params"])
    for r in res:
        np.testing.assert_allclose(r["pretrain"], want, rtol=1e-4, atol=1e-6)
        assert r["batch_error"] == "batch_size 3 must divide over the 'data' axis of 2 devices"


def test_sharded_full_scope_finetune_matches_single_device(cz_world):
    """The full-scope finetune through the sharded circuit: the
    parameter-shift estimator's batched shifted evaluations (vmap) run the
    collectives, and every amp rank draws the same shots from a generator
    seeded alike, so the history is the single-device one."""
    payload, _, res = cz_world
    c = payload["finetune"]
    m, cfg = _single(c, c["cfg"])
    _, want = tp.run_finetune(m, None, c["X"], c["Y"], DataStats(**STATS), cfg,
                              logger=_quiet())
    for r in res:
        np.testing.assert_allclose(r["finetune"], want, rtol=1e-4, atol=1e-6)


def test_evaluate_cz_fields_over_the_mesh(cz_world):
    """Each chunk split over 'data' and gathered in node order: every rank
    reports the metrics of the evaluation without a mesh."""
    from qcpinn_tpu_torch.utils.evaluation import evaluate_cz_fields

    payload, _, res = cz_world
    c = payload["eval"]
    m, _ = _single(c, {})
    want = evaluate_cz_fields(m, c["X"], c["Y"], batch=c["batch"], device="cpu")
    for r in res:
        assert set(r["eval"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], v, rtol=1e-5, err_msg=k)
