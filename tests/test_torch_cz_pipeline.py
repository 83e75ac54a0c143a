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
from qcpinn_tpu_torch.bridge import params_from_jax, params_to_jax
from qcpinn_tpu_torch.data.cz_loader import DataStats
from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
from qcpinn_tpu_torch.train import cz_pipeline as tp

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


@pytest.mark.parametrize("norm,weight", [("reference", 0.05), ("balanced", 0.05),
                                         ("coupled", 0.05), ("reference", 0.0)])
def test_pretrain_step_matches_jax(norm, weight):
    """One step from shared params on one batch (JAX's epoch of a single
    batch, its rows in JAX's shuffled order) against the port's
    ``step_fn``, physics engaged (warmup 0, ramp 1) or the data-only mode
    (weight 0): loss rtol 2e-5; the EMA state rtol 1e-4; params after the
    step within 2e-4 x the largest |param|. (Adam's first update is
    lr g / (|g| + eps): the to_quantum biases' gradients sit near eps at
    this size, so a leafwise scale would read float noise in g as error.)"""
    b = 8
    X, Y = _data(b)
    cfg = dict(n_qubits=2, n_layers=1, epochs=4, batch_size=b, physics_weight=weight,
               physics_warmup=0, physics_ramp=1, physics_normalize=norm, seed=0)
    jm = JModel(2, 1, width=4, remat=False)
    params = jm.init(jax.random.PRNGKey(3))
    tm = _model()
    if norm == "coupled":
        from qcpinn_tpu.models.si_gated import coupled_weighting_init as j_init
        from qcpinn_tpu_torch.models.si_gated import coupled_weighting_init

        params = {**params, "loss_bal": j_init()}
        tm.loss_bal = coupled_weighting_init()
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    opt, epoch_fn, _ = jp.make_pretrain_epoch(jm, X, Y, JStats(**STATS), jp.CzConfig(**cfg))
    ema = {k: jnp.asarray(1.0) for k in tp.EMA_KEYS}
    key = jax.random.PRNGKey(0)
    want, _, want_ema, m = epoch_fn(params, opt.init(params), ema,
                                    jnp.asarray(1.0, jnp.float32), key)

    ep = tp.make_pretrain_epoch(tm, X, Y, DataStats(**STATS), tp.CzConfig(**cfg))
    assert ep.n_batches == 1 and ep.data_only == (weight == 0.0)
    perm = np.asarray(jax.random.permutation(key, b))
    out = ep.step_fn(torch.tensor(X[perm]), torch.tensor(Y[perm]),
                     tp._phys_weight(ep.cfg, 1.0), tp._cosine_lr(ep.cfg.lr, 1.0, ep.cfg.epochs))
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


def test_chunked_residual_under_remat_gives_the_same_step(monkeypatch):
    """remat with the forward-mode residual: the residual and its gradient
    in chunks of rows give the step of the whole batch."""
    monkeypatch.setattr(tp, "REMAT_ROWS", 3)
    X, Y = _data(8)
    base = dict(n_qubits=2, n_layers=1, batch_size=8, physics_warmup=0, physics_ramp=1,
                physics_normalize="balanced")
    outs, models = [], []
    for remat in (False, True):
        m = _model(seed=2)
        ep = tp.make_pretrain_epoch(m, X, Y, DataStats(**STATS), tp.CzConfig(**base, remat=remat))
        assert (ep.chunk_rows is not None) == remat
        outs.append(ep.step_fn(torch.tensor(X), torch.tensor(Y), 0.05, 1e-3))
        models.append(m)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=0)
    scale = max(float(p.abs().max()) for p in models[0].parameters())
    for a, b in zip(models[1].parameters(), models[0].parameters()):
        assert float((a - b).abs().max()) <= 2e-4 * scale


def test_full_scope_finetune_matches_jax():
    """Exact readout (shots=None), full scope: the parameter-shift backward
    and Adam at finetune_lr, 2 epochs, against JAX's run_finetune: the loss
    history rtol 1e-4, the params after within 2e-4 x the largest |param|."""
    X, Y = _data(30, seed=1)
    cfg = dict(n_qubits=2, n_layers=1, finetune_epochs=2, calib_size=4, shots=None,
               train_scope="full", finetune_lr=1e-2, noise_readout=0.02)
    jm = JModel(2, 1, width=4, remat=False)
    params = jm.init(jax.random.PRNGKey(4))
    want, jhist = jp.run_finetune(jm, params, X, Y, JStats(**STATS), jp.CzConfig(**cfg),
                                  logger=type("L", (), {"print": lambda self, m: None})())
    tree = jax.tree_util.tree_map(np.asarray, params)
    m, hist = tp.run_finetune(_model(), tree, X, Y, DataStats(**STATS), tp.CzConfig(**cfg),
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
