"""The port's command line (qcpinn_tpu_torch/cli.py) at toy width on the
CPU (``main(argv, device="cpu")``): every problem with both ported
solvers, --best-val and the loss balancers, the JAX CLI's flags and
--metrics-json keys, the run directory, and the options that wait for
later items."""

import json
import math
import os

import numpy as np
import pytest
import torch

from qcpinn_tpu import cli as jcli
from qcpinn_tpu_torch import cli
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.utils.checkpoint import load_checkpoint

PROBLEMS = ["diffusion", "diffusion_sine", "wave", "klein_gordon", "helmholtz",
            "navier_stokes"]
TOY = ["--epochs", "2", "--print-every", "1", "--hidden-dim", "4", "--batch-size", "9",
       "--num-qubits", "2", "--eval-grid", "3", "--no-plots"]


def _run(tmp_path, *extra):
    out = str(tmp_path / "m.json")
    argv = ["train", *TOY, "--output-dir", str(tmp_path / "runs"), "--metrics-json", out,
            *extra]
    assert cli.main(argv, device="cpu") == 0
    with open(out) as f:
        return json.load(f)


def _run_dir(tmp_path):
    (name,) = os.listdir(tmp_path / "runs")
    return tmp_path / "runs" / name


@pytest.mark.parametrize("solver", ["DV", "Classical"])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_train_every_problem(problem, solver, tmp_path):
    m = _run(tmp_path, "--problem", problem, "--solver", solver)
    assert set(m) == {"command", "config", "metrics", "final_loss", "trainable_params"}
    assert m["command"].startswith("python -m qcpinn_tpu_torch.cli train ")
    assert m["config"]["problem"] == problem and m["config"]["solver"] == solver
    assert math.isfinite(m["final_loss"])
    want = {"rel_l2_u_percent"} | ({"rel_l2_r_percent"} if problem == "diffusion" else set())
    assert set(m["metrics"]) == want and all(math.isfinite(v) for v in m["metrics"].values())
    run = _run_dir(tmp_path)
    assert {"config.json", "output.log", "model.npz", "model.json"} <= set(os.listdir(run))
    assert os.path.exists(run / "circuit.txt") == (solver == "DV")
    log = (run / "output.log").read_text()
    assert "Epoch: 2/2 | Loss: " in log and f"trainable parameters: {m['trainable_params']}" in log


def test_best_val_and_checkpoint(tmp_path):
    m = _run(tmp_path, "--solver", "Classical", "--best-val", "--epochs", "3")
    run = _run_dir(tmp_path)
    log = (run / "output.log").read_text()
    assert "best-val tracking on (512-point analytic set: 256 interior + 2 wall/IC samplers)" in log
    assert "restoring best-validation params" in log
    # the checkpoint holds the params the metrics were taken on
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.data import diffusion as dd
    from qcpinn_tpu_torch.physics import diffusion_operator
    from qcpinn_tpu_torch.utils.evaluation import evaluate_relative_l2

    model = cli.make_model(QCPINNConfig.from_dict(m["config"]), "cpu")
    ck = load_checkpoint(str(run / "model"), model)
    model.load_state_dict(params_from_jax(ck["bundle"]["params"]))
    again = evaluate_relative_l2(model, dd.u, analytic_r=dd.r_true,
                                 operator=diffusion_operator, num=3, device="cpu")
    assert again == m["metrics"]
    assert ck["epoch"] == 3 and len(ck["loss_history"]) == 3


@pytest.mark.parametrize("balancer", ["ema", "uncertainty"])
def test_loss_balancers(balancer, tmp_path):
    m = _run(tmp_path, "--loss-balancer", balancer, "--problem", "navier_stokes")
    assert m["config"]["loss_balancer"] == balancer and math.isfinite(m["final_loss"])
    # the log-variances train (one a term, six terms); the EMA state is a
    # buffer
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.models.nn_core import count_trainable

    base = count_trainable(cli.make_model(QCPINNConfig.from_dict(m["config"]), "cpu"))
    assert m["trainable_params"] == base + (6 if balancer == "uncertainty" else 0)
    log = (_run_dir(tmp_path) / "output.log").read_text()
    assert f"adaptive loss balancer: {balancer}" in log


def test_plots_and_diagram(tmp_path):
    pytest.importorskip("matplotlib")
    argv = ["train", *[a for a in TOY if a != "--no-plots"], "--output-dir",
            str(tmp_path / "runs"), "--metrics-json", str(tmp_path / "m.json")]
    assert cli.main(argv, device="cpu") == 0
    files = set(os.listdir(_run_dir(tmp_path)))
    assert {"loss_history.pdf", "loss_history.png", "contour_plots.pdf", "tricontourf_0.pdf",
            "circuit.txt", "circuit.pdf"} <= files
    text = (_run_dir(tmp_path) / "circuit.txt").read_text()
    assert text.startswith("ansatz=cascade n=2 layers=1") and "q 0:" in text


def test_flags_match_the_jax_cli():
    want = vars(jcli.build_parser().parse_args(["train"]))
    got = vars(cli.build_parser().parse_args(["train"]))
    assert got == want
    jt = jcli.build_parser()._subparsers._group_actions[0].choices["train"]
    tt = cli.build_parser()._subparsers._group_actions[0].choices["train"]
    choices = {a.dest: a.choices for a in jt._actions}
    assert {a.dest: a.choices for a in tt._actions} == choices


@pytest.mark.parametrize("argv,match", [
    (["train", "--solver", "CV"], "the CV solver"),
    (["train", "--data-parallel"], "parallel"),
    (["crystal", "--spsa-steps", "5"], "crystal and SI-gated"),
    (["cz", "--phase", "pretrain", "--data", "x"], "Czochralski flagship"),
])
def test_unported_options_raise(argv, match, tmp_path):
    out = ["--output-dir", str(tmp_path / "out")] if argv[0] == "train" else []
    with pytest.raises(NotImplementedError, match=match):
        cli.main([*argv, *out], device="cpu")
    assert not os.path.exists(tmp_path / "out")  # refused before any run directory


JAX_METRICS_KEYS = {"command", "config", "metrics", "final_loss", "trainable_params"}


@pytest.mark.parametrize("flags", [
    ["--gradient-mode", "parameter-shift", "--shots", "256"],
    ["--gradient-mode", "spsa"],
    ["--gradient-mode", "spsa-split"],
    ["--noise-per-gate", "0.01"],
])
def test_hardware_modes_run(flags, tmp_path):
    """The hardware-fidelity modes through ``cli train`` on the CPU: a few
    epochs each, the metrics JSON with the JAX CLI's keys (the set its
    records in artifacts/spsa_ab_*.json hold), the mode's log line."""
    m = _run(tmp_path, *flags, "--epochs", "3")
    with open(os.path.join(os.path.dirname(__file__), "..", "artifacts",
                           "spsa_ab_split.json")) as f:
        assert set(json.load(f)) <= JAX_METRICS_KEYS == set(m)
    assert math.isfinite(m["final_loss"])
    assert all(math.isfinite(v) for v in m["metrics"].values())
    assert m["config"]["gradient_mode"] == (flags[1] if flags[0] == "--gradient-mode"
                                           else "backprop")
    log = (_run_dir(tmp_path) / "output.log").read_text()
    want = {"parameter-shift": "parameter-shift gradients on value terms (shots=256)",
            "spsa": "SPSA updates on the FULL pytree (a=0.005); shots=None",
            "spsa-split": "split updates: SPSA (a=0.005) on quantum leaves ('q',)"}
    assert want.get(flags[1], "Epoch: 3/3 | Loss: ") in log and "Epoch: 3/3 | Loss: " in log


def test_train_refuses_unknown_flags():
    with pytest.raises(SystemExit):
        cli.main(["train", "--no-such-flag"], device="cpu")


def test_shots_are_logged_as_ignored(tmp_path):
    m = _run(tmp_path, "--shots", "64")
    log = (_run_dir(tmp_path) / "output.log").read_text()
    assert "shots=64 ignored: backprop mode" in log and m["config"]["shots"] == 64
    assert np.isfinite(m["final_loss"]) and torch.get_default_dtype() == torch.float32
