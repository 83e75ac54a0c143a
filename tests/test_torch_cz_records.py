"""Where the Czochralski eval numbers that ``chip_smoke.py`` holds the port
to come from (``pytest -m slow tests/test_torch_cz_records.py``, about 40 s
a checkpoint on the CPU): JAX's own evaluation of each of its six Cz
checkpoints on the full real melt data (``CZ_JAX_CPU_EVAL``), and why the
artifacts' TPU eval records differ from it. JAX's ``fourier_features_apply``
calls ``jnp.dot`` without ``precision=HIGHEST``; on the TPU that rounds the
projection's inputs to bf16, and the checkpoints were trained and recorded
so. The port with those inputs rounded to bf16 lands on the records."""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from qcpinn_tpu.data.cz_loader import DataStats as JStats
from qcpinn_tpu.data.cz_loader import load_cz_data as j_load
from qcpinn_tpu.models.czochralski import Hybrid16QPINN as JModel
from qcpinn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from qcpinn_tpu.utils.evaluation import evaluate_cz_fields as j_evaluate
from qcpinn_tpu_torch.bridge import params_from_jax
from qcpinn_tpu_torch.data.cz_loader import DataStats, load_cz_data
from qcpinn_tpu_torch.models import czochralski as tcz
from qcpinn_tpu_torch.utils.checkpoint import load_checkpoint
from qcpinn_tpu_torch.utils.evaluation import evaluate_cz_fields

REPO = os.path.join(os.path.dirname(__file__), "..")
RAW = os.path.join(REPO, "data", "cz_melt_raw.txt")


def _width(ckpt):
    return 384 if "wide384" in ckpt else 128


def _stats(ckpt):
    with open(os.path.join(REPO, ckpt + ".stats.json")) as f:
        return json.load(f)


@pytest.mark.slow
@pytest.mark.parametrize("ckpt", sorted(chip_smoke.CZ_JAX_CPU_EVAL))
def test_jax_cpu_eval_of_the_checkpoints(ckpt):
    """JAX's evaluate_cz_fields of the checkpoint on the CPU gives
    CZ_JAX_CPU_EVAL (rtol 1e-4); the TPU record, where there is one, lies
    more than 10% below it in val_mse."""
    X, Y, _ = j_load(RAW, JStats.from_dict(_stats(ckpt)))
    model = JModel(16, 2, width=_width(ckpt), remat=False)
    params = j_load_checkpoint(os.path.join(REPO, ckpt), {
        "params": model.init(jax.random.PRNGKey(0)), "opt_state": None,
        "sched": None})["bundle"]["params"]
    got = j_evaluate(model.apply, params, X, Y, batch=256)
    for k, v in chip_smoke.CZ_JAX_CPU_EVAL[ckpt].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4)
    record = os.path.join(REPO, ckpt + "_eval.json")
    if os.path.exists(record):
        with open(record) as f:
            assert json.load(f)["val_mse"] < 0.9 * got["val_mse"]


def _ff_bf16(B, x):
    """The Fourier projection as the TPU's default-precision dot computes
    it: both inputs rounded to bf16, the sum in f32."""
    proj = 2.0 * math.pi * (x.to(torch.bfloat16).float() @ B.detach().to(torch.bfloat16).float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


@pytest.mark.slow
@pytest.mark.parametrize("ckpt,field_rtol", [("artifacts/cz_real_wide384_400", 0.01),
                                             ("artifacts/cz_real_balanced", 0.03)])
def test_tpu_records_follow_the_bf16_fourier_projection(ckpt, field_rtol, monkeypatch):
    """The port on the CPU with the Fourier projection's inputs rounded to
    bf16 reproduces the TPU eval record: wide384_400 every field within
    1% and val_mse within 2%; balanced within 3% and 2%."""
    X, Y, _ = load_cz_data(RAW, DataStats.from_dict(_stats(ckpt)))
    model = tcz.Hybrid16QPINN(16, 2, width=_width(ckpt), remat=False, device="cpu")
    path = os.path.join(REPO, ckpt)
    model.load_state_dict(params_from_jax(load_checkpoint(path, model)["bundle"]["params"]))
    monkeypatch.setattr(tcz.nc, "fourier_features_apply", _ff_bf16)
    got = evaluate_cz_fields(model, X, Y, batch=256, device="cpu")
    with open(path + "_eval.json") as f:
        record = json.load(f)
    for k, v in record.items():
        np.testing.assert_allclose(got[k], v, rtol=0.02 if k == "val_mse" else field_rtol)


@pytest.mark.slow
def test_finetune_record_command_matches_jax_on_the_cpu(capsys):
    """The cz_real_finetune record's command (head scope, 100 epochs,
    --shots 4096 --calib-size 8, seed 42) from cz_real_balanced, by both
    packages on the CPU with the projection in f32: every metric of the
    port's result within a factor 2 of JAX's (their draws differ), and so
    are the first and last losses. Prints both (``pytest -s``)."""
    from qcpinn_tpu.train.cz_pipeline import CzConfig as JConfig
    from qcpinn_tpu.train.cz_pipeline import run_finetune as j_run_finetune
    from qcpinn_tpu_torch.train.cz_pipeline import CzConfig, run_finetune

    ckpt = "artifacts/cz_real_balanced"
    path = os.path.join(REPO, ckpt)
    quiet = type("Quiet", (), {"print": lambda self, msg: None})()
    cfg = dict(finetune_epochs=100, shots=4096, calib_size=8, train_scope="head", seed=42)

    X, Y, _ = j_load(RAW, JStats.from_dict(_stats(ckpt)))
    jm = JModel(16, 2, width=128, remat=False)
    params = j_load_checkpoint(path, {"params": jm.init(jax.random.PRNGKey(0)),
                                      "opt_state": None, "sched": None})["bundle"]["params"]
    jparams, jhist = j_run_finetune(jm, params, X, Y, JStats.from_dict(_stats(ckpt)),
                                    JConfig(**cfg), logger=quiet)
    want = j_evaluate(jm.apply, jparams, X, Y, batch=256)

    model = tcz.Hybrid16QPINN(16, 2, width=128, remat=False, device="cpu")
    tree = load_checkpoint(path, model)["bundle"]["params"]
    model, hist = run_finetune(model, tree, X, Y, DataStats.from_dict(_stats(ckpt)),
                               CzConfig(**cfg), logger=quiet)
    got = evaluate_cz_fields(model, X, Y, batch=256, device="cpu")
    with capsys.disabled():
        print(json.dumps({"jax": want, "port": got, "jax_loss_first_last": [jhist[0], jhist[-1]],
                          "port_loss_first_last": [hist[0], hist[-1]]}))
    for k, v in want.items():
        assert 0.5 <= got[k] / v <= 2.0, (k, got[k], v)
    for a, b in ((hist[0], jhist[0]), (hist[-1], jhist[-1])):
        assert 0.5 <= a / b <= 2.0
