"""The port's Czochralski data pieces (qcpinn_tpu_torch/data/cz_loader.py,
data/scaler.py) against the JAX package's: the table parser, the
nondimensionalization with and without a checkpoint's stats, the
calibration subset, the boundary masks and the Scaler."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.data import cz_loader as jl
from qcpinn_tpu.data.scaler import Scaler as JScaler
from qcpinn_tpu_torch.data import cz_loader as tl
from qcpinn_tpu_torch.data.scaler import Scaler

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
FILES = ["cz_melt_synthetic.txt", "cz_melt_raw.txt"]


@pytest.mark.parametrize("name", FILES)
def test_read_table_bit_equal(name):
    path = os.path.join(DATA, name)
    got, want = tl.read_table(path), jl.read_table(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("name", FILES)
def test_load_cz_data_bit_equal(name, with_stats):
    path = os.path.join(DATA, name)
    stats = None
    if with_stats:  # a checkpoint's stats: the real-data record's sidecar
        with open(os.path.join(DATA, "..", "artifacts", "cz_real_balanced.stats.json")) as f:
            stats = json.load(f)
    X, Y, s = tl.load_cz_data(path, tl.DataStats.from_dict(stats) if stats else None)
    JX, JY, js = jl.load_cz_data(path, jl.DataStats.from_dict(stats) if stats else None)
    assert X.dtype == Y.dtype == np.float32
    np.testing.assert_array_equal(X, JX)
    np.testing.assert_array_equal(Y, JY)
    assert s.to_dict() == js.to_dict() and s.to_json() == js.to_json()
    assert s.temp_scale == js.temp_scale
    assert tl.DataStats.from_dict({**s.to_dict(), "extra": 1.0}) == s


def test_load_cz_data_rejects_other_widths(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("% header\n1 2 3\n4 5 6\n")
    with pytest.raises(ValueError, match="Expected 7 or >= 9"):
        tl.load_cz_data(str(p))
    p.write_text("% only comments\n")
    with pytest.raises(ValueError, match="no numeric rows"):
        tl.read_table(str(p))


@pytest.mark.parametrize("size", [1, 8, 33, 5000])
def test_calibration_subset_matches_jax(size):
    X, Y, _ = tl.load_cz_data(os.path.join(DATA, FILES[0]))
    xs, ys = tl.choose_calibration_subset(X, Y, size)
    jxs, jys = jl.choose_calibration_subset(X, Y, size)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)


@pytest.mark.parametrize("tol", [1e-3, 5e-2])
def test_boundary_masks_match_jax(tol):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(0, 1, (64, 2)), [[0.0, 0.3], [1.0, 0.5], [0.2, 0.0],
                                                      [0.4, 1.0]]]).astype(np.float32)
    got, want = tl.infer_boundary_masks(x, tol), jl.infer_boundary_masks(x, tol)
    assert set(got) == set(want) == {"axis", "outer_wall", "inlet", "outlet"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].any()


@pytest.mark.parametrize("mode", ["minmax", "maxabs", "standard"])
def test_scaler_matches_jax(mode):
    vals = np.random.default_rng(0).uniform(-3, 7, (50, 2))
    sc, jsc = Scaler.fit(vals, mode), JScaler.fit(vals, mode)
    np.testing.assert_array_equal(sc.shift, jsc.shift)
    np.testing.assert_array_equal(sc.scale, jsc.scale)
    x = vals[:5].astype(np.float32)
    xt = torch.tensor(x)
    np.testing.assert_allclose(sc.transform(xt).numpy(), np.asarray(jsc.transform(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(sc.inverse(sc.transform(xt)).numpy(), x, rtol=1e-5, atol=1e-6)
    g = torch.tensor(vals[:3, :].astype(np.float32))
    np.testing.assert_allclose(sc.d_dphys(g).numpy(), np.asarray(jsc.d_dphys(jnp.asarray(g.numpy()))),
                               rtol=1e-6)
    np.testing.assert_allclose(sc.d2_dphys2(g[:, 0], col=0).numpy(),
                               np.asarray(jsc.d2_dphys2(jnp.asarray(g[:, 0].numpy()), col=0)),
                               rtol=1e-6)
    back = Scaler.from_dict(sc.to_dict())
    assert back.to_dict() == jsc.to_dict()
    np.testing.assert_array_equal(back.scale, sc.scale)


def test_scaler_chain_rule_against_autograd():
    """du/dx_phys = (du/dx_hat) / scale and the second-derivative factor,
    against torch autograd through transform (the JAX test's check)."""
    vals = np.random.default_rng(0).uniform(-3, 7, (50, 2))
    sc = Scaler.fit(vals, "minmax")
    x0 = torch.tensor(vals[:1].astype(np.float32), requires_grad=True)

    def g(xh):
        return torch.sum(torch.sin(xh[:, 0]) * xh[:, 1] ** 2)

    (grad_phys,) = torch.autograd.grad(g(sc.transform(x0)), x0)
    xh = sc.transform(x0).detach().requires_grad_(True)
    (grad_hat,) = torch.autograd.grad(g(xh), xh)
    np.testing.assert_allclose(grad_phys.numpy(), sc.d_dphys(grad_hat).numpy(), rtol=1e-5)
    f2 = torch.autograd.functional.hessian(lambda xp: g(sc.transform(xp.reshape(1, 2))),
                                           x0.detach().reshape(-1))
    g2 = torch.autograd.functional.hessian(lambda h: g(h.reshape(1, 2)), xh.detach().reshape(-1))
    np.testing.assert_allclose(f2[0, 0].numpy(), sc.d2_dphys2(g2[0, 0], col=0).numpy(),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="unknown mode"):
        Scaler.fit(vals, "bogus")
