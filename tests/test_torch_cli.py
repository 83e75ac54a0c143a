"""The port's command line (qcpinn_tpu_torch/cli.py) at toy width on the
CPU (``main(argv, device="cpu")``): every problem with the DV and
Classical solvers, the CV solver's run, ``crystal``'s run, --best-val and
the loss balancers, the JAX CLI's flags (``train`` and ``crystal``) and
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


@pytest.mark.parametrize("command", ["train", "crystal"])
def test_flags_match_the_jax_cli(command):
    """The subcommand's flags, defaults and choices are the JAX CLI's."""
    want = vars(jcli.build_parser().parse_args([command]))
    got = vars(cli.build_parser().parse_args([command]))
    assert got == want
    jt = jcli.build_parser()._subparsers._group_actions[0].choices[command]
    tt = cli.build_parser()._subparsers._group_actions[0].choices[command]
    choices = {a.dest: a.choices for a in jt._actions}
    assert {a.dest: a.choices for a in tt._actions} == choices


@pytest.mark.parametrize("argv,match", [
    (["train", "--data-parallel", "--epochs", "2", "--num-qubits", "2", "--hidden-dim", "4",
      "--batch-size", "6", "--eval-grid", "3", "--no-plots"], None),
    (["cz", "--phase", "pretrain", "--data", "x", "--amp", "2"],
     "--amp 2 does not divide the 1 available devices"),
])
def test_unported_options_raise(argv, match, tmp_path):
    """The parallel options, ported: a lone process runs as a world of one
    (``train --data-parallel`` trains, rank 0 writing one run directory);
    ``cz --amp 2`` on that world stops with JAX's message before any run
    directory exists."""
    import torch.distributed as dist

    out = tmp_path / "out"
    try:
        if match is None:
            assert cli.main([*argv, "--output-dir", str(out)], device="cpu") == 0
            assert len(os.listdir(out)) == 1
        else:
            with pytest.raises(SystemExit, match=match):
                cli.main([*argv, "--output-dir", str(out)], device="cpu")
            assert not os.path.exists(out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


JAX_METRICS_KEYS = {"command", "config", "metrics", "final_loss", "trainable_params"}


@pytest.mark.parametrize("cv_class", [1, 3])
def test_cv_solver_runs(cv_class, tmp_path):
    """``train --solver CV`` (2 qumodes, cutoff 3): the metrics JSON with
    the JAX CLI's keys (its CV records' set), the CV diagram in the run
    directory, the solver's trainable count."""
    m = _run(tmp_path, "--solver", "CV", "--cutoff-dim", "3", "--cv-class", str(cv_class),
             "--epochs", "2")
    with open(os.path.join(os.path.dirname(__file__), "..", "artifacts",
                           "cv_diffusion_class1.json")) as f:
        assert set(json.load(f)) == JAX_METRICS_KEYS == set(m)
    assert m["config"]["solver"] == "CV" and m["config"]["cv_class"] == cv_class
    assert all(math.isfinite(v) for v in [m["final_loss"], *m["metrics"].values()])
    # pre 3-4-2, post 2-4-1, the layer's 2 x 3 interferometer angles and
    # 5 x 2 gate parameters (+ 2 cubic, 4 cross-Kerr, 4 input scale/phase)
    assert m["trainable_params"] == 26 + 17 + 16 + (10 if cv_class == 3 else 0)
    run = _run_dir(tmp_path)
    text = (run / "circuit.txt").read_text()
    assert text.startswith(f"CV circuit: variant {cv_class}, 2 qumodes, 1 layers, cutoff 3")
    log = (run / "output.log").read_text()
    assert "CV circuit diagram written (circuit.txt / circuit.pdf)" in log
    assert "Epoch: 2/2 | Loss: " in log


def test_cv_solver_keeps_jax_refusal_of_parameter_shift(tmp_path):
    """The CV solver has no hardware apply: parameter-shift raises, as in
    JAX; spsa trains it."""
    with pytest.raises(ValueError, match="needs a solver with a hardware apply"):
        _run(tmp_path, "--solver", "CV", "--cutoff-dim", "3", "--gradient-mode",
             "parameter-shift")
    m = _run(tmp_path, "--solver", "CV", "--cutoff-dim", "3", "--gradient-mode", "spsa",
             "--epochs", "2")
    assert m["config"]["gradient_mode"] == "spsa" and math.isfinite(m["final_loss"])


def test_crystal_runs_and_writes_its_artifact(tmp_path):
    """``crystal`` (2 qubits, 1 layer, warmup and spsa): the artifact with
    the JAX CLI's summary keys, the run directory's log."""
    art = str(tmp_path / "crystal.json")
    argv = ["crystal", "--n-qubits", "2", "--n-layers", "1", "--spsa-steps", "3",
            "--warmup-epochs", "1", "--n-bulk", "4", "--n-interface", "4",
            "--output-dir", str(tmp_path / "runs"), "--artifact", art]
    assert cli.main(argv, device="cpu") == 0
    with open(art) as f:
        m = json.load(f)
    assert set(m) == {"config", "params_total", "params_quantum", "warmup_history",
                      "spsa_history", "spsa_first5_mean", "spsa_last5_mean"}
    assert len(m["spsa_history"]) == 3 and m["params_quantum"] == 6
    log = (_run_dir(tmp_path) / "output.log").read_text()
    assert "[SPSA] step 3/3 | crystal loss: " in log and "artifact written to " in log


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
