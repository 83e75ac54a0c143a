"""The Czochralski reference against the program's plain CPU path at small
sizes: the melt data, the model's fields, the five residual terms and a
whole step's readings."""

import os

import numpy as np
import pytest
import torch

from conftest import small_cell
from lib.spec import ROOT, reference

ref = reference("cz_hybrid16q")


def _port(n, seed):
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from lib.spec import system

    cell = small_cell("cz16-pretrain-b256")
    cell.config["n_qubits"] = n
    model = Hybrid16QPINN(n, cell.config["n_layers"], remat=False,
                          width=cell.config["trunk_width"], device="cpu")
    weights = system(cell.traffic).draw_weights(model, cell.config, seed, torch.device("cpu"))
    model.load_state_dict(weights)
    return cell.config, model, weights


def test_melt_data_as_the_loader_reads_it():
    from qcpinn_tpu_torch.data.cz_loader import load_cz_data

    path = os.path.join(ROOT, "data", "cz_melt_raw.txt")
    X, Y, stats = load_cz_data(path)
    Xr, Yr, pc = ref.load_melt(path)
    assert X.shape == (18108, 2)
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(Y, Yr)
    assert pc == pytest.approx(stats.pressure_coeff, rel=1e-12)


@pytest.mark.parametrize("n,seed", [(4, 3), (5, 2**31 + 11)])
def test_fields_and_residual_terms(n, seed):
    from qcpinn_tpu_torch.physics.operators_fwd import cz_residuals_fwd

    cfg, model, weights = _port(n, seed)
    x = torch.rand((6, 2), generator=torch.Generator().manual_seed(seed % 1000))
    x[:, 0] += 0.05  # away from the axis clamp
    jet = ref.Model(cfg, weights)(x)
    torch.testing.assert_close(jet[0], model(x).detach(), rtol=1e-5, atol=1e-6)
    total, terms = cz_residuals_fwd(model, x, 3.0, cfg["re"], cfg["pr"], cfg["gr"])
    res = ref.melt_residuals(jet, x, 3.0, cfg["re"], cfg["pr"], cfg["gr"])
    for k in ref.PHYS_KEYS:
        assert float(torch.mean(res[k] ** 2)) == pytest.approx(float(terms[k].detach()), rel=2e-4)


def test_a_step_follows_the_program():
    import run

    cell = small_cell("cz16-pretrain-b256")
    out = run.measure(cell, 2**31 + 5, 0.2, False, torch.device("cpu"), fault=None)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["loss_gap"] < 1e-4 and checks["grad_gap"] < 1e-4, checks
    assert checks["update_gap"] < 1e-2, checks
