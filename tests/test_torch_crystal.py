"""The port's phase-field crystal pipeline (qcpinn_tpu_torch/physics/
phase_field.py, models/crystal.py, train/crystal.py, ``cli crystal``)
against the JAX package's on the same numpy inputs and the same weights,
carried across by the bridge: the phase-field terms, ``crystal_growth_loss``
at the same points (rtol 1e-5), the interface selection on JAX's own
candidate draws (the same points), ``CrystalPINN`` with the exact readout
(forward atol 2e-5, grads within 2e-4 x max|ref| of each leaf) and its
sampled readout by the binomial law, and one warmup step and one spsa /
spsa-split update on JAX's draws and perturbation. JAX's compiled
references (its second- and third-order derivatives through the circuit
take tens of seconds to compile) come from a process started with the
module, so their compilation overlaps the other tests."""

import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.models.crystal import CrystalPINN as JModel
from qcpinn_tpu.physics import phase_field as jpf
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax, params_to_jax
from qcpinn_tpu_torch.models.crystal import CrystalPINN as TModel
from qcpinn_tpu_torch.physics import phase_field as tpf
from qcpinn_tpu_torch.train import crystal as tcr
from qcpinn_tpu_torch.train import spsa as tspsa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L = 2, 1
CFG = dict(n_qubits=N, n_layers=L, n_bulk=6, n_interface=6, seed=0, log_every=1)


def ref_inputs():
    """The inputs of the compiled references: the points the loss is held
    at, the toy model's weights, and the points the model is held at."""
    return (np.random.default_rng(5).uniform(0.0, 1.0, (12, 2)).astype(np.float32),
            (0.3 * np.random.default_rng(1).standard_normal((2, 5))).astype(np.float32),
            np.random.default_rng(4).uniform(size=(6, 2)).astype(np.float32))


REF_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from qcpinn_tpu.models.crystal import CrystalPINN
from qcpinn_tpu.physics.phase_field import crystal_growth_loss
from qcpinn_tpu.train.crystal import CrystalConfig, train_crystal

{INPUTS}
N, L, CFG = {N}, {L}, {CFG}
x, W, xm = (jnp.asarray(a) for a in ref_inputs())
model = CrystalPINN(N, L)
k_init, _, _ = jax.random.split(jax.random.PRNGKey(CFG["seed"]), 3)
p0 = model.init(k_init)


def toy(X):  # 5 outputs, phi crossing zero (tests/test_phase_field.py)
    phi = jnp.sin(2 * jnp.pi * X[:, 0:1]) * jnp.cos(jnp.pi * X[:, 1:2])
    return jnp.concatenate([jnp.tanh(X @ W)[:, :4], phi], axis=1)


out = {{}}
runs = {{"warm_split": dict(warmup_epochs=1, spsa_steps=1, mode="spsa-split")}}
if sys.argv[2] == "a":
    out["loss"] = np.asarray(jax.jit(
        lambda p: crystal_growth_loss(lambda X: model.apply(p, X), x))(p0))
    out["toy_loss"] = np.asarray(jax.jit(lambda X: crystal_growth_loss(toy, X))(x))
    big = CrystalPINN(3, 2)
    pb = big.init(k_init)
    out["big_out"] = np.asarray(jax.jit(big.apply)(pb, xm))
    gb = jax.jit(jax.grad(lambda p: jnp.sum(big.apply(p, xm) ** 2)))(pb)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(gb)):
        out[f"big_g{{i}}"] = np.asarray(leaf)
    runs = {{"spsa": dict(warmup_epochs=0, spsa_steps=1, mode="spsa")}}
for tag, kw in runs.items():
    params, hist = train_crystal(model, CrystalConfig(**CFG, **kw), params=p0)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"{{tag}}_p{{i}}"] = np.asarray(leaf)
    out[f"{{tag}}_warmup"] = np.asarray(hist["warmup_history"], np.float64)
    out[f"{{tag}}_spsa"] = np.asarray(hist["spsa_history"], np.float64)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    """JAX's compiled references, from two processes started with the
    module: (a) the crystal loss of the toy model and of CrystalPINN(N, L)
    at the points of ``ref_inputs()``, CrystalPINN(3, 2)'s output and the
    gradient of sum(out^2), and from the JAX init of CFG one spsa update;
    (b) from that init one warmup step then one spsa-split update
    (``train_crystal``). ``get()`` waits for both."""
    d = tmp_path_factory.mktemp("crystal_ref")
    script = REF_SCRIPT.format(INPUTS=inspect.getsource(ref_inputs), N=N, L=L,
                               CFG=repr(CFG))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {part: subprocess.Popen([sys.executable, "-c", script, str(d / part), part],
                                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for part in ("a", "b")}
    data = {}

    def get():
        if not data:
            for part, proc in procs.items():
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
                with np.load(str(d / part) + ".npz") as f:
                    data.update(f)
        return data

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _keys(seed=0):
    """JAX train_crystal's key schedule: (k_init, k_warm, k_train)."""
    return jax.random.split(jax.random.PRNGKey(seed), 3)


def _draws(key, n_bulk, n_interface):
    """The candidate draws of JAX's adaptive_interface_sampling(key)."""
    k_bulk, k_cand = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_bulk, (n_bulk, 2))),
            np.asarray(jax.random.uniform(k_cand, (5 * n_interface, 2))))


def _pair(n=N, layers=L):
    jm = JModel(n, layers)
    params = _np(jm.init(_keys()[0]))
    tm = TModel(n, layers, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def test_phase_field_terms_match_jax():
    rng = np.random.default_rng(0)
    phi, px, py, lap, c = (rng.normal(size=7).astype(np.float32) for _ in range(5))
    J = [jnp.asarray(a) for a in (phi, px, py, lap, c)]
    T = [torch.tensor(a) for a in (phi, px, py, lap, c)]
    for got, want in (
        (tpf.anisotropic_epsilon(T[1], T[2]), jpf.anisotropic_epsilon(J[1], J[2])),
        (tpf.phase_field_mu(*T), jpf.phase_field_mu(*J)),
        (tpf.stefan_residual(T[0], T[1], T[2], T[4]),
         jpf.stefan_residual(J[0], J[1], J[2], J[4])),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for k in ("EPS0", "DELTA_ANISO", "ANISO_M", "LAMBDA_C", "LAMBDA_T"):
        assert getattr(tpf, k) == getattr(jpf, k)


def _toy(W, lib):
    """A 5-output toy model whose phi crosses zero (tests/test_phase_field.py;
    the reference process's ``toy``)."""
    def apply(x):
        if lib is torch:
            phi = torch.sin(2 * np.pi * x[:, 0:1]) * torch.cos(np.pi * x[:, 1:2])
            return torch.cat([torch.tanh(x @ torch.tensor(W))[:, :4], phi], dim=1)
        phi = jnp.sin(2 * jnp.pi * x[:, 0:1]) * jnp.cos(jnp.pi * x[:, 1:2])
        return jnp.concatenate([jnp.tanh(x @ jnp.asarray(W))[:, :4], phi], axis=1)

    return apply


def _step_phi(lib):
    """phi on a coarse staircase: many exact ties, below the threshold (at 0)
    and above it, so the selection's order among ties shows."""
    def apply(x):
        if lib is torch:
            phi = torch.round(4.0 * x[:, 0:1]) / 4.0 - 0.5
            return torch.cat([torch.zeros_like(x[:, :1]).expand(-1, 4), phi], dim=1)
        phi = jnp.round(4.0 * x[:, 0:1]) / 4.0 - 0.5
        return jnp.concatenate([jnp.zeros((x.shape[0], 4)), phi], axis=1)

    return apply


@pytest.mark.parametrize("apply_pair", ["toy", "staircase"])
def test_interface_selection_on_jax_draws(apply_pair):
    """JAX's adaptive_interface_sampling(key) and the port's selection on
    JAX's own candidate draws for that key: the same points in the same
    order (a stable sort, as jnp.argsort)."""
    W = (0.3 * np.random.default_rng(1).standard_normal((2, 5))).astype(np.float32)
    j_apply, t_apply = ((_toy(W, jnp), _toy(W, torch)) if apply_pair == "toy"
                        else (_step_phi(jnp), _step_phi(torch)))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jpf.adaptive_interface_sampling(j_apply, key, n_bulk=8,
                                                          n_interface=16))
        x_bulk, x_cand = _draws(key, 8, 16)
        got = tpf.select_interface(t_apply, torch.tensor(x_bulk), torch.tensor(x_cand), 16)
        np.testing.assert_array_equal(got.numpy(), want)


def test_adaptive_sampling_draws_from_the_generator():
    _, _, tm = _pair()
    gen = torch.Generator().manual_seed(3)
    pts = tpf.adaptive_interface_sampling(tm, gen, n_bulk=8, n_interface=16)
    assert pts.shape == (24, 2) and not pts.requires_grad
    again = tpf.adaptive_interface_sampling(tm, torch.Generator().manual_seed(3), n_bulk=8,
                                            n_interface=16)
    assert torch.equal(pts, again)
    with torch.no_grad():
        near = tm(pts[8:])[:, 4].abs().mean()
        rand = tm(torch.rand(16, 2, generator=gen))[:, 4].abs().mean()
    assert near <= rand


def test_sampled_readout_follows_the_binomial_law():
    """64 draws at S = 1024 of the global parity: each mean within 4 sigma /
    sqrt(64) of the exact value, the pooled variance within 25% of
    (1 - <Z..Z>^2) / S; no gradient; a key is required."""
    _, _, tm = _pair(3, 2)
    q_in = torch.tensor(np.random.default_rng(6).uniform(-1, 1, (5, 3)).astype(np.float32))
    z = tm.quantum_scalar(tm.q, q_in).detach()
    gen = torch.Generator().manual_seed(7)
    draws = torch.stack([tm.quantum_scalar(tm.q, q_in, shots=1024, key=gen)
                         for _ in range(64)])
    sigma2 = (1.0 - z**2) / 1024
    assert float(((draws.mean(0) - z).abs() / (4.0 * torch.sqrt(sigma2) / 8.0)).max()) <= 1.0
    assert abs(float((draws.var(0) / sigma2).mean()) - 1.0) <= 0.25
    assert not draws.requires_grad
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        tm.quantum_scalar(tm.q, q_in, shots=16)


def test_trainer_runs_and_logs(tmp_path):
    """``cli crystal`` on the CPU: the JAX CLI's log lines, its summary keys
    in --artifact, and a --save checkpoint the JAX package loads."""
    from qcpinn_tpu.utils.checkpoint import load_checkpoint as j_load
    from qcpinn_tpu_torch import cli

    art, save = str(tmp_path / "a.json"), str(tmp_path / "ck")
    argv = ["crystal", "--n-qubits", "2", "--n-layers", "1", "--spsa-steps", "4",
            "--warmup-epochs", "2", "--n-bulk", "6", "--n-interface", "6", "--log-every", "2",
            "--mode", "spsa-split", "--output-dir", str(tmp_path / "runs"),
            "--artifact", art, "--save", save]
    assert cli.main(argv, device="cpu") == 0
    with open(art) as f:
        m = json.load(f)
    assert set(m) == {"config", "params_total", "params_quantum", "warmup_history",
                      "spsa_history", "spsa_first5_mean", "spsa_last5_mean"}
    assert (m["params_total"], m["params_quantum"]) == (2573, 6)
    assert len(m["warmup_history"]) == 2 and len(m["spsa_history"]) == 4
    assert m["spsa_last5_mean"] == pytest.approx(sum(m["spsa_history"]) / 4)
    assert m["config"] == {**tcr.CrystalConfig().__dict__, "n_qubits": 2, "n_layers": 1,
                           "spsa_steps": 4, "warmup_epochs": 2, "n_bulk": 6, "n_interface": 6,
                           "log_every": 2, "mode": "spsa-split"}
    (run,) = os.listdir(tmp_path / "runs")
    log = (tmp_path / "runs" / run / "output.log").read_text()
    for line in ("crystal config: {", "classical warmup: 2 Adam epochs, loss ",
                 "[SPSA-split] step 2/4 | crystal loss: ", "[SPSA-split] step 4/4",
                 "parameters: 2573 (quantum: 6)", "checkpoint saved to ",
                 "artifact written to "):
        assert line in log, line
    like = {"params": _np(JModel(2, 1).init(jax.random.PRNGKey(0))), "opt_state": None,
            "sched": None}
    restored = j_load(save, like)
    assert restored["epoch"] == 4 and restored["loss_history"] == m["spsa_history"]
    tm = TModel(2, 1, device="cpu")
    tm.load_state_dict(params_from_jax(restored["bundle"]["params"]))
    assert tm.q.shape == (6,)


def test_record_init_is_jax_init():
    """artifacts/crystal_growth_init (the on-card record check's start) holds
    JAX's initial weights of the record's config."""
    from qcpinn_tpu.utils.checkpoint import load_checkpoint as j_load

    with open(os.path.join(REPO, "artifacts", "crystal_growth.json")) as f:
        c = json.load(f)["config"]
    want = _np(JModel(c["n_qubits"], c["n_layers"]).init(_keys(c["seed"])[0]))
    got = j_load(os.path.join(REPO, "artifacts", "crystal_growth_init"),
                 {"params": want, "opt_state": None, "sched": None})["bundle"]["params"]
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)



def test_crystal_growth_loss_matches_jax(jax_ref):
    """The toy model and CrystalPINN at the same points: rtol 1e-5; the
    loss is differentiable in the model's parameters."""
    x, W, _ = ref_inputs()
    got = tpf.crystal_growth_loss(_toy(W, torch), torch.tensor(x))
    np.testing.assert_allclose(float(got.detach()), float(jax_ref()["toy_loss"]), rtol=1e-5)
    _, _, tm = _pair()
    loss = tpf.crystal_growth_loss(tm, torch.tensor(x))
    np.testing.assert_allclose(float(loss.detach()), float(jax_ref()["loss"]), rtol=1e-5)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.parameters())


def test_model_matches_jax(jax_ref):
    """The ansatz op for op, the gate counts, the exact forward (atol 2e-5)
    and the gradient of sum(out^2) leaf by leaf (2e-4 x max|ref|), at
    3 qubits and 2 layers."""
    jm, params, tm = _pair(3, 2)
    assert tm.num_q_params == jm.num_q_params == 18
    assert [(o.kind, o.wires, o.pidx) for o in tm.program] == [
        (o.kind, o.wires, o.pidx) for o in jm.program]
    assert tm.gate_counts_per_wire() == jm.gate_counts_per_wire()
    ref = jax_ref()
    out = tm(torch.tensor(ref_inputs()[2]))
    np.testing.assert_allclose(out.detach().numpy(), ref["big_out"], atol=2e-5)
    (out**2).sum().backward()
    got = jax.tree_util.tree_leaves(grads_to_jax_layout(tm))
    for i, a in enumerate(got):
        w = ref[f"big_g{i}"]
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-4 * np.abs(w).max())
    back = params_to_jax(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)


def _queue(monkeypatch, draws, delta=None):
    """Feed the port JAX's candidate draws, in order, and JAX's
    perturbation of ``q``."""
    draws = list(draws)

    def draw_candidates(generator, n_bulk, n_cand, device=None):
        x_bulk, x_cand = draws.pop(0)
        assert (len(x_bulk), len(x_cand)) == (n_bulk, n_cand)
        return torch.tensor(x_bulk), torch.tensor(x_cand)

    monkeypatch.setattr(tpf, "draw_candidates", draw_candidates)
    if delta is not None:
        monkeypatch.setattr(tspsa, "_rademacher_like", lambda key, leaves: [torch.tensor(delta)])
    return draws


def _run_port(mode, warmup):
    _, params, tm = _pair()
    cfg = tcr.CrystalConfig(**CFG, warmup_epochs=warmup, spsa_steps=1, mode=mode)
    return tcr.train_crystal(tm, cfg, params=params, device="cpu")


def _assert_after(tm, ref, tag):
    """The parameters after the run within 2e-4 x the largest |param| (Adam's
    first step is lr g / (|g| + eps)), q within 1e-6."""
    got = params_to_jax(tm)
    leaves = jax.tree_util.tree_leaves(got)
    want = [ref[f"{tag}_p{i}"] for i in range(len(leaves))]
    scale = max(np.abs(w).max() for w in want)
    for a, w in zip(leaves, want):
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(got["q"], want[-1], atol=1e-6)


def test_warmup_and_split_update_match_jax(monkeypatch, jax_ref):
    """One warmup step (Adam on the classical leaves, q frozen) then one
    spsa-split update (SPSA on q at constant gains, Adam on the classical
    leaves from the unperturbed point), from JAX's init, on JAX's draws
    (the warmup's, then the split's plus, minus and gradient evaluations)
    and its perturbation: the losses rtol 1e-5, the parameters after."""
    _, k_warm, k_train = _keys()
    kk = jax.random.fold_in(jax.random.fold_in(k_train, 0), 0)
    k_delta, k_plus, k_minus, k_grad = jax.random.split(kk, 4)
    delta = np.asarray(jax.random.randint(jax.random.split(k_delta, 1)[0], (3 * N * L,),
                                          0, 2).astype(jnp.float32) * 2.0 - 1.0)
    nb, ni = CFG["n_bulk"], CFG["n_interface"]
    left = _queue(monkeypatch, [_draws(jax.random.fold_in(k_warm, 0), nb, ni)]
                  + [_draws(k, nb, ni) for k in (k_plus, k_minus, k_grad)], delta)
    tm, hist = _run_port("spsa-split", 1)
    assert not left
    ref = jax_ref()
    np.testing.assert_allclose(hist["warmup_history"], ref["warm_split_warmup"], rtol=1e-5)
    np.testing.assert_allclose(hist["spsa_history"], ref["warm_split_spsa"], rtol=1e-5)
    _assert_after(tm, ref, "warm_split")


def test_spsa_update_matches_jax(monkeypatch, jax_ref):
    """One spsa update of q alone (the classical leaves untouched), from
    JAX's init, on JAX's plus and minus draws and its perturbation: the
    mean loss rtol 1e-5, q within 1e-6."""
    _, _, k_train = _keys()
    kk = jax.random.fold_in(jax.random.fold_in(k_train, 0), 0)
    k_delta, k_plus, k_minus = jax.random.split(kk, 3)
    delta = np.asarray(jax.random.randint(jax.random.split(k_delta, 1)[0], (3 * N * L,),
                                          0, 2).astype(jnp.float32) * 2.0 - 1.0)
    nb, ni = CFG["n_bulk"], CFG["n_interface"]
    left = _queue(monkeypatch, [_draws(k, nb, ni) for k in (k_plus, k_minus)], delta)
    _, params, _ = _pair()
    tm, hist = _run_port("spsa", 0)
    assert not left and hist["warmup_history"] == []
    ref = jax_ref()
    np.testing.assert_allclose(hist["spsa_history"], ref["spsa_spsa"], rtol=1e-5)
    _assert_after(tm, ref, "spsa")
    for k, p in tm.named_parameters():
        if not k.startswith("q"):
            torch.testing.assert_close(p, params_from_jax(params)[k], rtol=0, atol=0)
