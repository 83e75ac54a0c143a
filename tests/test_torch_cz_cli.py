"""``python -m qcpinn_tpu_torch.cli cz`` on the CPU (``main(argv,
device="cpu")``) against the JAX CLI's: the flags, the three phases through
the argv surface with the checkpoint handoff both ways between the
packages, the guards, the refusals, and the real-data checkpoint evaluated
by both packages."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu import cli as jcli
from qcpinn_tpu.data.cz_loader import DataStats as JStats
from qcpinn_tpu.data.cz_loader import load_cz_data as j_load
from qcpinn_tpu.models.czochralski import Hybrid16QPINN as JModel
from qcpinn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from qcpinn_tpu.utils.evaluation import evaluate_cz_fields as j_evaluate
from qcpinn_tpu_torch import cli
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.data.cz_loader import DataStats, load_cz_data
from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
from qcpinn_tpu_torch.utils.checkpoint import load_checkpoint
from qcpinn_tpu_torch.utils.evaluation import evaluate_cz_fields

REPO = os.path.join(os.path.dirname(__file__), "..")
SYNTH = os.path.join(REPO, "data", "cz_melt_synthetic.txt")
RAW = os.path.join(REPO, "data", "cz_melt_raw.txt")


@pytest.fixture
def small_data(tmp_path):
    """The synthetic export's header and its first 64 nodes."""
    path = tmp_path / "cz_small.txt"
    with open(SYNTH) as f:
        lines = f.readlines()
    header = [line for line in lines if line.startswith("%")]
    path.write_text("".join(header + lines[len(header):len(header) + 64]))
    return str(path)


def _cz_parser(mod):
    return mod.build_parser()._subparsers._group_actions[0].choices["cz"]


def test_flags_match_the_jax_cli():
    argv = ["cz", "--phase", "eval", "--data", "d"]
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    assert got == want
    choices = {a.dest: a.choices for a in _cz_parser(jcli)._actions}
    assert {a.dest: a.choices for a in _cz_parser(cli)._actions} == choices


def _metrics(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def test_cz_three_phase_roundtrip(tmp_path, capsys):
    """pretrain -> warm-started pretrain -> finetune -> eval through the
    argv surface at 3 qubits; the port's finetuned checkpoint evaluated by
    the JAX CLI gives the port's metrics (rtol 1e-4)."""
    ck, ck2, ck_ft = (str(tmp_path / k) for k in ("ck", "ck2", "ck_ft"))
    out = str(tmp_path / "runs")
    base = ["cz", "--data", SYNTH, "--n-qubits", "3", "--n-layers", "1", "--batch-size", "256",
            "--physics-warmup", "0", "--physics-ramp", "1", "--log-every", "5",
            "--output-dir", out, "--trunk-width", "8"]
    assert cli.main(base + ["--phase", "pretrain", "--epochs", "2", "--save", ck,
                            "--physics-normalize", "balanced"], device="cpu") == 0
    assert all(os.path.exists(ck + s) for s in (".npz", ".json", ".stats.json"))
    text = capsys.readouterr().out
    assert "[PRETRAIN] epoch 0002/2" in text and "trainable parameters:" in text
    with open(ck + ".json") as f:
        manifest = json.load(f)
    assert manifest["epoch"] == 2 and len(manifest["loss_history"]) == 2
    assert manifest["config"]["trunk_width"] == 8 and manifest["stats"]["pressure_coeff"] > 0

    assert cli.main(base + ["--phase", "pretrain", "--epochs", "1", "--save", ck2,
                            "--load", ck], device="cpu") == 0
    assert "warm start from" in capsys.readouterr().out

    assert cli.main(base + ["--phase", "finetune", "--epochs", "2", "--load", ck2,
                            "--save", ck_ft, "--shots", "128", "--calib-size", "4",
                            "--train-scope", "head", "--no-plots"], device="cpu") == 0
    text = capsys.readouterr().out
    assert "[FINETUNE] epoch 0002/2" in text and "scope=head" in text
    assert not glob.glob(os.path.join(out, "*", "data_fields*"))

    assert cli.main(base + ["--phase", "eval", "--load", ck_ft], device="cpu") == 0
    text = capsys.readouterr().out
    assert "checkpoint's stats sidecar" in text
    metrics = _metrics(text)
    assert set(metrics) == {"val_mse", *(f"rel_l2_{k}_percent"
                                         for k in ("u_r", "u_z", "u_theta", "p", "T"))}
    assert np.isfinite(list(metrics.values())).all()
    assert glob.glob(os.path.join(out, "*", "eval_fields.png"))

    # the JAX CLI reads the port's bundle and evaluates it alike
    assert jcli.main(base + ["--phase", "eval", "--load", ck_ft, "--no-plots"]) == 0
    jmetrics = _metrics(capsys.readouterr().out)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=1e-4)


def test_cz_finetune_full_scope_with_diagnostics(tmp_path, capsys, small_data):
    """A JAX pretrain checkpoint finetuned by the port in full scope, with
    the pre-finetune diagnostic plots; the noise flags reach the step."""
    ck, ck_ft = str(tmp_path / "jax"), str(tmp_path / "ft")
    out = str(tmp_path / "runs")
    base = ["cz", "--data", small_data, "--n-qubits", "2", "--n-layers", "1",
            "--trunk-width", "4", "--output-dir", out]
    assert jcli.main(base + ["--phase", "pretrain", "--epochs", "1", "--batch-size", "32",
                             "--physics-weight", "0", "--save", ck]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--phase", "finetune", "--epochs", "2", "--load", ck,
                            "--save", ck_ft, "--shots", "64", "--calib-size", "4",
                            "--train-scope", "full", "--noise-readout", "0.01",
                            "--noise-per-gate", "0.001"], device="cpu") == 0
    text = capsys.readouterr().out
    assert "x 21 evals/step x 4 samples x 64 shots (scope=full)" in text
    for name in ("data_fields.png", "calib_coverage.png", "initial_pred_vs_gt.png",
                 "quantum_weights_hist.png", "weight_audit.txt"):
        assert glob.glob(os.path.join(out, "cz-finetune-*", name)), name
    restored = load_checkpoint(ck_ft, Hybrid16QPINN(2, 1, width=4, device="cpu"))
    assert restored["epoch"] == 2 and restored["bundle"]["opt_state"] is None


def test_cz_quick_check(tmp_path, capsys, small_data):
    ck = str(tmp_path / "q")
    assert cli.main(["cz", "--phase", "pretrain", "--data", small_data, "--quick-check",
                     "--physics-weight", "0", "--trunk-width", "4", "--save", ck,
                     "--output-dir", str(tmp_path / "runs")], device="cpu") == 0
    text = capsys.readouterr().out
    assert "quick-check mode: 2 epochs, tiny circuit" in text
    with open(ck + ".json") as f:
        config = json.load(f)["config"]
    assert (config["epochs"], config["n_qubits"], config["n_layers"],
            config["batch_size"]) == (2, 4, 1, 4)


def test_cz_guards(tmp_path):
    """The argument guards raise SystemExit, not crashes (JAX's
    tests/test_cli.py:87-95)."""
    base = ["cz", "--data", SYNTH, "--output-dir", str(tmp_path / "runs"), "--n-qubits", "2",
            "--trunk-width", "4"]
    with pytest.raises(SystemExit, match="requires --save"):
        cli.main(base + ["--phase", "pretrain", "--epochs", "1"], device="cpu")
    with pytest.raises(SystemExit, match="requires --load"):
        cli.main(base + ["--phase", "eval"], device="cpu")
    with pytest.raises(SystemExit, match="requires --load"):
        cli.main(base + ["--phase", "finetune", "--save", str(tmp_path / "x")], device="cpu")


@pytest.mark.parametrize("field,value", [("trunk_width", 384), ("n_qubits", 8),
                                         ("n_layers", 3)])
def test_cz_architecture_mismatch_fails_loudly(tmp_path, field, value):
    ck = str(tmp_path / "wide")
    with open(ck + ".json", "w") as f:
        json.dump({"num_leaves": 28, "config": {field: value}}, f)
    base = ["cz", "--data", SYNTH, "--output-dir", str(tmp_path / "runs")]
    flag = "--" + field.replace("_", "-")
    with pytest.raises(SystemExit, match=f"{flag} {value}"):
        cli.main(base + ["--phase", "eval", "--load", ck], device="cpu")
    with pytest.raises(SystemExit, match=f"{flag} {value}"):
        cli.main(base + ["--phase", "pretrain", "--epochs", "1", "--load", ck,
                         "--save", str(tmp_path / "x")], device="cpu")


@pytest.mark.parametrize("flags", [["--amp", "2"], ["--data-parallel"]])
def test_cz_parallel_flags_raise(tmp_path, flags, capsys, small_data):
    """The parallel flags, ported, in a lone process (a world of one):
    ``--amp 2`` stops with JAX's message before any run directory;
    ``--data-parallel`` pretrains (the quick check) and evaluates on the
    mesh, the metrics those of the evaluation without it."""
    import torch.distributed as dist

    out = tmp_path / "runs"
    try:
        if flags == ["--amp", "2"]:
            with pytest.raises(SystemExit, match="--amp 2 does not divide the 1 available"):
                cli.main(["cz", "--phase", "eval", "--data", SYNTH, "--output-dir", str(out),
                          *flags], device="cpu")
            assert not out.exists()
            return
        ck = str(tmp_path / "q")
        base = ["cz", "--data", small_data, "--n-qubits", "3", "--n-layers", "1",
                "--trunk-width", "4", "--output-dir", str(out), "--no-plots"]
        assert cli.main([*base, "--phase", "pretrain", "--epochs", "1", "--batch-size", "16",
                         "--save", ck, *flags], device="cpu") == 0
        assert "mesh {'data': 1, 'amp': 1}" in capsys.readouterr().out
        assert cli.main([*base, "--phase", "eval", "--load", ck, *flags], device="cpu") == 0
        got = _metrics(capsys.readouterr().out)
        assert cli.main([*base, "--phase", "eval", "--load", ck], device="cpu") == 0
        assert got == _metrics(capsys.readouterr().out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sidecar_lost_restores_stats_from_the_manifest(tmp_path, capsys):
    """Eval without the .stats.json sidecar takes the manifest's stats (the
    normalized space the model was trained in), as JAX's cmd_cz does."""
    src = os.path.join(REPO, "artifacts", "cz_real_balanced")
    ck = str(tmp_path / "ck")
    for ext in (".npz", ".json"):
        with open(src + ext, "rb") as f, open(ck + ext, "wb") as g:
            g.write(f.read())
    stats, manifest = cli._checkpoint_handoff(
        cli.build_parser().parse_args(["cz", "--phase", "eval", "--data", RAW, "--load", ck]))
    with open(src + ".stats.json") as f:
        assert stats == DataStats.from_dict(json.load(f))
    assert manifest["epoch"] == 300


@pytest.fixture(scope="module")
def real_nodes():
    """16 evenly spaced nodes of the real melt data, normalized with the
    wide384_400 checkpoint's stats (both loaders)."""
    with open(os.path.join(REPO, "artifacts", "cz_real_wide384_400.stats.json")) as f:
        stats = json.load(f)
    X, Y, _ = load_cz_data(RAW, DataStats.from_dict(stats))
    JX, JY, _ = j_load(RAW, JStats.from_dict(stats))
    np.testing.assert_array_equal(X, JX)
    idx = np.linspace(0, len(X) - 1, 16).astype(np.int64)
    return X[idx], Y[idx]


def test_real_checkpoint_matches_jax(real_nodes):
    """artifacts/cz_real_wide384_400 (16 qubits, trunk 384) loaded by both
    packages and evaluated on 16 real nodes: the fields rtol 1e-4 of JAX's
    (atol 1e-6 where a field is near 0), the field metrics rtol 1e-4."""
    X, Y = real_nodes
    path = os.path.join(REPO, "artifacts", "cz_real_wide384_400")
    jm = JModel(16, 2, width=384, remat=False)
    jparams = j_load_checkpoint(path, {"params": jm.init(jax.random.PRNGKey(0)),
                                       "opt_state": None, "sched": None})["bundle"]["params"]
    tm = Hybrid16QPINN(16, 2, width=384, remat=False, device="cpu")
    restored = load_checkpoint(path, tm)
    tm.load_state_dict(params_from_jax(restored["bundle"]["params"]))
    assert restored["epoch"] == 400 and restored["stats"]["pressure_coeff"] > 1e5
    with torch.no_grad():
        got = tm(torch.tensor(X)).numpy()
    want = np.asarray(jax.jit(jm.apply)(jparams, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    m, pred = evaluate_cz_fields(tm, X, Y, batch=8, return_pred=True, device="cpu")
    jmetrics = j_evaluate(jm.apply, jparams, X, Y, batch=8)
    np.testing.assert_allclose(pred, want, rtol=1e-4, atol=1e-6)
    for k, v in m.items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=1e-4)
