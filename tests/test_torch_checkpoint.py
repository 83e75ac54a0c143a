"""Checkpoints across the packages (utils/checkpoint.py): a params bundle
the JAX package saved loads into the port, and one the port saved loads
into the JAX package with a JAX template, leaf for leaf; an optimizer
state loads only into the package that saved it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models import ClassicalSolver as JClassical
from qcpinn_tpu.models import DVSolver as JDV
from qcpinn_tpu.models.dv_fourier import DVFourierSolver as JFourier
from qcpinn_tpu.train import inject_balancer_params as j_inject
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu.utils import checkpoint as jck
from qcpinn_tpu_torch.bridge import params_from_jax, params_to_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.models import ClassicalSolver as TClassical
from qcpinn_tpu_torch.models import DVFourierSolver as TFourier
from qcpinn_tpu_torch.models import DVSolver as TDV
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train.loop import inject_balancer_params
from qcpinn_tpu_torch.utils import checkpoint as tck

TERMS = dict.fromkeys(("res", "bc", "ic"))


def _pair(kind, balancer="none"):
    kw = dict(classic_network=(3, 6, 1), num_qubits=3, q_ansatz="cross_mesh", seed=4)
    if kind == "DV":
        jm, tm = JDV(JConfig(**kw)), TDV(TConfig(**kw), device="cpu")
    elif kind == "Classical":
        jm = JClassical(JConfig(solver="Classical", **kw))
        tm = TClassical(TConfig(solver="Classical", **kw), device="cpu")
    else:
        fk = dict(mapping_size=4, skip_dim=4, rbf_count=2,
                  rbf_centers=np.full((2, 3), 0.5, np.float32))
        jm = JFourier(JConfig(**kw), **fk)
        tm = TFourier(TConfig(**kw), device="cpu",
                      **{**fk, "rbf_centers": torch.tensor(fk["rbf_centers"])})
    params = j_inject(jm.init(jax.random.PRNGKey(7)), TERMS, balancer)
    inject_balancer_params(tm, TERMS, balancer)
    return jm, params, tm


CASES = [("DV", "none"), ("Classical", "none"), ("Fourier", "none"), ("DV", "ema"),
         ("Classical", "uncertainty")]


@pytest.mark.parametrize("kind,balancer", CASES)
def test_jax_bundle_loads_into_the_port(kind, balancer, tmp_path):
    jm, params, tm = _pair(kind, balancer)
    path = str(tmp_path / "jax")
    jck.save_checkpoint(path, params, sched=jopt.plateau_init(), loss_history=[1.0, 0.5],
                        epoch=3, config={"solver": kind})
    ck = tck.load_checkpoint(path, tm)
    tm.load_state_dict(params_from_jax(ck["bundle"]["params"]))
    for a, w in zip(jax.tree_util.tree_leaves(params_to_jax(tm)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(w))
    assert (ck["epoch"], ck["loss_history"], ck["config"]) == (3, [1.0, 0.5], {"solver": kind})
    assert ck["bundle"]["opt_state"] is None and ck["bundle"]["rng"] is None
    assert float(ck["bundle"]["sched"].best) == float("inf")
    x = np.random.default_rng(0).uniform(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))), atol=2e-5)


@pytest.mark.parametrize("kind,balancer", CASES)
def test_port_bundle_loads_into_jax(kind, balancer, tmp_path):
    _, params, tm = _pair(kind, balancer)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.25)
    sched = topt.PlateauState(torch.tensor(0.125), torch.tensor(7, dtype=torch.int32),
                              torch.tensor(0.5))
    path = str(tmp_path / "port")
    tck.save_checkpoint(path, tm, sched=sched, epoch=9, stats={"mean": [1.0]})
    like = {"params": params, "opt_state": None, "sched": jopt.plateau_init()}
    out = jck.load_checkpoint(path, like)
    got = out["bundle"]
    assert jax.tree_util.tree_structure(got["params"]) == jax.tree_util.tree_structure(params)
    for a, w in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(params_to_jax(tm))):
        np.testing.assert_array_equal(np.asarray(a), w)
    assert (float(got["sched"].best), int(got["sched"].bad_epochs),
            float(got["sched"].scale)) == (0.125, 7, 0.5)
    assert out["epoch"] == 9 and out["stats"] == {"mean": [1.0]}


def test_optimizer_state_is_per_package(tmp_path):
    jm, params, tm = _pair("Classical")
    jo = jopt.make_optimizer(1e-3, grad_clip=1.0)
    jpath = str(tmp_path / "jax_opt")
    jck.save_checkpoint(jpath, params, opt_state=jo.init(params))
    with pytest.raises(ValueError, match="optimizer state saved by the JAX package"):
        tck.load_checkpoint(jpath, tm)

    to = topt.make_optimizer(1e-3, grad_clip=1.0)
    trainable = [p for p in tm.parameters() if p.requires_grad]
    state = to.init(trainable)
    state.count.add_(3)
    gen = torch.Generator().manual_seed(1)
    tpath = str(tmp_path / "port_opt")
    tck.save_checkpoint(tpath, tm, opt_state=state, rng=gen.get_state())
    back = tck.load_checkpoint(tpath, tm)["bundle"]
    assert int(back["opt_state"].count) == 3
    assert [m.shape for m in back["opt_state"].mu] == [p.shape for p in trainable]
    assert torch.equal(back["rng"], gen.get_state())
    # the JAX loader reads the params and never the port's optimizer state
    out = jck.load_checkpoint(tpath, {"params": params, "opt_state": None, "sched": None})
    assert jax.tree_util.tree_structure(out["bundle"]["params"]) == \
        jax.tree_util.tree_structure(params)
    with pytest.raises(ValueError, match="leaves"):
        jck.load_checkpoint(tpath, {"params": params, "opt_state": jo.init(params),
                                    "sched": None})


def test_flatten_is_jax_order():
    tree = {"b": [np.zeros(2), {"z": np.ones(1), "a": np.full(3, 2.0)}], "a": np.eye(2),
            "n": None}
    got = tck.flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    back = tck.unflatten(tree, got)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    with pytest.raises(ValueError, match="template"):
        tck.unflatten({"a": np.zeros(3)}, [np.zeros(2)])
