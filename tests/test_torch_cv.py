"""The port's CV photonic solver (qcpinn_tpu_torch/models/cv_layer.py,
cv_solver.py) against the JAX package's on the same numpy inputs and the
same parameters, carried across by the bridge: ``CVLayer`` of every
variant (forward in complex64, atol 1e-5 x max(1, |ref|); gradients and
the nested-jvp diffusion residual in complex128, rtol 1e-8), one
``cli train --solver CV`` train step in complex128 (loss rtol 2e-5, grads
within 2e-4 x max(|ref|, 1e-3) of each leaf, the train-step tests'
limit), the parameter layout, the readout overrides and the circuit
diagram. JAX's double-precision references come from two processes of
their own (JAX_ENABLE_X64=1 QCPINN_FOCK_DTYPE=complex128: its fock dtype
is fixed at import), started with the module and read by the tests at
its end, so that their compilation overlaps the other tests."""

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.config import QCPINNConfig as JConfig
from qcpinn_tpu.models.cv_layer import CVLayer as JLayer
from qcpinn_tpu.models.cv_layer import interferometer_wiring as j_wiring
from qcpinn_tpu.models.cv_solver import CVSolver as JSolver
from qcpinn_tpu_torch.bridge import grads_to_jax_layout, params_from_jax, params_to_jax
from qcpinn_tpu_torch.config import QCPINNConfig as TConfig
from qcpinn_tpu_torch.models.cv_layer import CVLayer as TLayer
from qcpinn_tpu_torch.models.cv_layer import interferometer_wiring as t_wiring
from qcpinn_tpu_torch.models.cv_solver import CVSolver as TSolver
from qcpinn_tpu_torch.ops import fock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, D = 3, 4
SCALE = 5.0  # the layer's parameters x 5 (not the input scale/phase): O(1) gates

# JAX in double: CVLayer of every variant (readouts, gradients, the
# residual of the first readout) ...
X64_LAYERS = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from qcpinn_tpu.models.cv_layer import CVLayer
from qcpinn_tpu.physics.operators_fwd import diffusion_operator_fwd

M, D, SCALE = {M}, {D}, {SCALE}
rng = np.random.default_rng(0)
out = {{}}
for v in (1, 2, 3):
    layer = CVLayer(M, 1, D, variant=v)
    p = {{k: np.asarray(a, np.float64) * (1.0 if k.startswith("input") else SCALE)
          for k, a in layer.init(jax.random.PRNGKey(v)).items()}}
    x = rng.uniform(-0.5, 0.5, (5, M))
    X = rng.uniform(0.0, 1.0, (4, M))
    y = layer.apply(p, x)
    gp, gx = jax.grad(lambda p, x: jnp.sum(layer.apply(p, x) ** 2), argnums=(0, 1))(p, x)
    u, r = diffusion_operator_fwd(lambda Xp: layer.apply(p, Xp)[:, :1], X)
    out.update({{f"v{{v}}_x": x, f"v{{v}}_X": X, f"v{{v}}_y": y, f"v{{v}}_gx": gx,
                f"v{{v}}_u": u, f"v{{v}}_r": r}})
    for k in p:
        out[f"v{{v}}_p_{{k}}"] = p[k]
        out[f"v{{v}}_g_{{k}}"] = gp[k]
np.savez(sys.argv[1], **{{k: np.asarray(a) for k, a in out.items()}})
"""

# ... and one train step of the CV solver (make_train_step, the diffusion
# terms on the fixed points POINTS writes, the forward-mode residual)
X64_STEP = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import optax
from qcpinn_tpu.config import QCPINNConfig
from qcpinn_tpu.data import diffusion as dd
from qcpinn_tpu.models.cv_solver import CVSolver
from qcpinn_tpu.physics import get_operator
from qcpinn_tpu.train import diffusion_terms, make_train_step
from qcpinn_tpu.train import optim

{POINTS}


class Fixed:
    def __init__(self, X, func):
        self.X, self.func = jnp.asarray(X), func

    def sample(self, key, n):
        return self.X[:n], self.func(self.X[:n])


X = points()
terms = diffusion_terms({{"res": Fixed(X["res"], dd.r), "bc1": Fixed(X["bc1"], dd.u),
                        "ics": Fixed(X["ics"], dd.u)}}, len(X["res"]))
model = CVSolver(QCPINNConfig(**{SOLVER}))
params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                model.init(jax.random.PRNGKey(1)))
seen = {{}}


def update(grads, state, params=None):
    seen["g"] = grads
    return jax.tree_util.tree_map(jnp.zeros_like, grads), state


opt = optax.GradientTransformation(lambda p: optax.EmptyState(), update)
step, _ = make_train_step(model.apply, get_operator("diffusion", "fwd"), terms, opt,
                          QCPINNConfig(solver="CV"), fuse_value_terms=True)
_, metrics = step((params, opt.init(params), optim.plateau_init()),
                  (jax.random.PRNGKey(0), jnp.int32(0)))
out = {{f"m_{{k}}": np.asarray(metrics[k]) for k in ("loss", "res", "bc", "ic")}}
for i, (a, g) in enumerate(zip(jax.tree_util.tree_leaves(params),
                               jax.tree_util.tree_leaves(seen["g"]))):
    out[f"p_{{i}}"], out[f"g_{{i}}"] = a, np.asarray(g)
np.savez(sys.argv[1], **out)
"""

def points(b=9):
    """The fixed points of the train-step check (the diffusion terms'
    residual, BC1 and IC rows), float64."""
    rng = np.random.default_rng(11)
    X = {"res": rng.uniform(size=(b, 3)), "bc1": rng.uniform(size=(b // 3, 3)),
         "ics": rng.uniform(size=(b // 3, 3))}
    X["bc1"][:, 1] = 0.0
    X["ics"][:, 0] = 0.0
    return X


POINTS = inspect.getsource(points)
SOLVER = dict(solver="CV", num_qubits=2, cutoff_dim=3, classic_network=(3, 6, 1), seed=3)


class _Reference:
    """A JAX process started now and read (once) when a test needs it."""

    def __init__(self, script, path):
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                   QCPINN_FOCK_DTYPE="complex128")
        self.path = path
        self.proc = subprocess.Popen([sys.executable, "-c", script, path], cwd=REPO,
                                     env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.data = None

    def get(self):
        if self.data is None:
            _, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            with np.load(self.path) as data:
                self.data = dict(data)
        return self.data

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_x64(tmp_path_factory):
    """The two JAX double-precision references, started with the module."""
    d = tmp_path_factory.mktemp("cv_x64")
    refs = {"layers": _Reference(X64_LAYERS.format(M=M, D=D, SCALE=SCALE),
                                 str(d / "layers.npz")),
            "step": _Reference(X64_STEP.format(POINTS=POINTS, SOLVER=repr(SOLVER)),
                               str(d / "step.npz"))}
    yield refs
    for ref in refs.values():
        ref.close()


@pytest.fixture
def double_engine(monkeypatch):
    monkeypatch.setattr(fock, "CDTYPE", torch.complex128)
    monkeypatch.setattr(fock, "FDTYPE", torch.float64)


def _jax_params(variant):
    layer = JLayer(M, 1, D, variant=variant)
    return {k: np.asarray(a) * (1.0 if k.startswith("input") else SCALE)
            for k, a in layer.init(jax.random.PRNGKey(variant)).items()}


def _port_layer(variant, params, dtype=torch.float32):
    layer = TLayer(M, 1, D, variant=variant).to(dtype)
    layer.load_state_dict({k: torch.tensor(a, dtype=dtype) for k, a in params.items()})
    return layer


def test_wiring_and_leaves_match_jax():
    for m in range(1, 6):
        assert t_wiring(m) == j_wiring(m)
    for v in (1, 2, 3):
        want = JLayer(3, 2, 3, variant=v).init(jax.random.PRNGKey(0))
        got = dict(TLayer(3, 2, 3, variant=v).named_parameters())
        assert {k: tuple(a.shape) for k, a in want.items()} == {
            k: tuple(p.shape) for k, p in got.items()}


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_layer_forward_matches_jax(variant):
    """complex64: every readout within 1e-5 x max(1, |ref|)."""
    rng = np.random.default_rng(variant)
    params = _jax_params(variant)
    x = rng.uniform(-0.5, 0.5, (6, M)).astype(np.float32)
    want = np.asarray(JLayer(M, 1, D, variant=variant).apply(params, jnp.asarray(x)))
    got = _port_layer(variant, params)(torch.tensor(x)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def _solver_pair(**kw):
    cfg = dict(solver="CV", num_qubits=2, cutoff_dim=4, classic_network=(3, 6, 1), seed=3,
               **kw)
    jm = JSolver(JConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm = TSolver(TConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def test_solver_layout_and_bridge():
    """755 trainable parameters at the records' width (4 qumodes, hidden 50,
    as artifacts/cv_diffusion_class1.json), the JAX tree's layout both ways
    through the bridge, the config's cv_readout passed through."""
    from qcpinn_tpu_torch.models.nn_core import count_trainable

    cfg = dict(solver="CV", num_qubits=4, cutoff_dim=6, classic_network=(3, 50, 1))
    assert count_trainable(TSolver(TConfig(**cfg), device="cpu")) == 755
    jm, params, tm = _solver_pair(cv_class=3)
    back = params_to_jax(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))), atol=2e-5)
    assert TSolver(TConfig(**cfg, cv_readout="x"), device="cpu").cv.readout == "x"


def test_readout_and_sd_overrides():
    """readout= overrides the reference's per-variant readout; v2's default
    is 'x'; a bad readout raises; active_sd scales the init."""
    assert TLayer(2, 1, 4, variant=3).readout == "n"
    assert TLayer(2, 1, 4, variant=2).readout == "x"
    assert TLayer(2, 1, 4, variant=3, readout="x").readout == "x"
    with pytest.raises(ValueError, match="readout"):
        TLayer(2, 1, 4, variant=1, readout="p")
    with pytest.raises(ValueError, match="variant"):
        TLayer(2, 1, 4, variant=4)
    g = torch.Generator().manual_seed(0)
    big = TLayer(2, 1, 4, variant=1, active_sd=0.3, generator=g).squeezing_r
    g = torch.Generator().manual_seed(0)
    ref = TLayer(2, 1, 4, variant=1, generator=g).squeezing_r
    torch.testing.assert_close(big, ref * 3000.0)
    params = _jax_params(3)
    x = torch.rand(3, M)
    n_out = _port_layer(3, params)(x)
    layer_x = TLayer(M, 1, D, variant=3, readout="x")
    layer_x.load_state_dict({k: torch.tensor(a) for k, a in params.items()})
    want = JLayer(M, 1, D, variant=3, readout="x").apply(params, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(layer_x(x).detach().numpy(), np.asarray(want), atol=1e-5)
    assert not torch.allclose(n_out, layer_x(x))


def test_circuit_diagram_matches_jax(tmp_path):
    from qcpinn_tpu.utils.drawing import cv_circuit_text as j_text
    from qcpinn_tpu_torch.utils.drawing import draw_cv_circuit

    for v in (1, 2, 3):
        text = draw_cv_circuit(TLayer(3, 2, 5, variant=v), str(tmp_path))
        assert text == j_text(JLayer(3, 2, 5, variant=v))
        assert (tmp_path / "circuit.txt").read_text() == text + "\n"


def test_op_label_matches_jax():
    from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
    from qcpinn_tpu.utils.drawing import _op_label as j_label
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.utils.drawing import _op_label

    for ansatz in ("cross_mesh", "cascade", "sim_circ_15"):
        got = [_op_label(op) for op in DVCircuit(4, 1, ansatz, seed=1).program]
        want = [j_label(op) for op in JCircuit(4, 1, ansatz, seed=1).program]
        assert got == want


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_layer_grads_and_residual_match_jax_in_double(variant, jax_x64, double_engine):
    """complex128 on both sides: the readouts, the gradient of
    sum(readout^2) for every parameter and for the inputs, and the
    convection-diffusion residual of the first readout by nested jvps,
    each rtol 1e-8 (atol 1e-8 x the largest gradient, for leaves whose
    gradient is exactly zero: Kerr and cross-Kerr just before the number
    readout commute with it)."""
    from qcpinn_tpu_torch.physics import diffusion_operator_fwd

    ref = {k[len(f"v{variant}_"):]: a for k, a in jax_x64["layers"].get().items()
           if k.startswith(f"v{variant}_")}
    params = {k[2:]: a for k, a in ref.items() if k.startswith("p_")}
    layer = _port_layer(variant, params, torch.float64)
    x = torch.tensor(ref["x"]).requires_grad_(True)
    y = layer(x)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], rtol=1e-8, atol=1e-12)
    (y**2).sum().backward()
    grads = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    grads["x"] = x.grad.numpy()
    want = {k[2:]: a for k, a in ref.items() if k.startswith("g_")}
    want["x"] = ref["gx"]
    assert set(grads) == set(want)
    floor = 1e-8 * max(np.abs(a).max() for a in want.values())
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], rtol=1e-8, atol=floor, err_msg=k)
    u, r = diffusion_operator_fwd(lambda X: layer(X)[:, :1], torch.tensor(ref["X"]))
    np.testing.assert_allclose(u.detach().numpy(), ref["u"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r.detach().numpy(), ref["r"], rtol=1e-8,
                               atol=1e-8 * np.abs(ref["r"]).max())


class _Fixed:
    """A sampler that returns preset points (JAX's in the reference)."""

    def __init__(self, X, func):
        self.X, self.func = torch.tensor(X), func

    def sample(self, _key, n):
        return self.X[:n], self.func(self.X[:n])


def test_train_step_matches_jax_in_double(jax_x64, double_engine):
    """One ``cli train --solver CV`` step (make_train_step, the diffusion
    terms at fixed points, the forward-mode residual through the CV
    circuit), complex128 on both sides from the same weights: the loss and
    each term rtol 2e-5, every gradient within 2e-4 x max(|ref|, 1e-3) of
    its leaf (the train-step tests' limit: the Kerr leaf's gradient is
    exactly zero before the number readout)."""
    from qcpinn_tpu_torch.data import diffusion as tdd
    from qcpinn_tpu_torch.physics import get_operator
    from qcpinn_tpu_torch.train import optim as topt
    from qcpinn_tpu_torch.train.loop import diffusion_terms, make_train_step

    ref = jax_x64["step"].get()
    treedef = jax.tree_util.tree_structure(JSolver(JConfig(**SOLVER)).init(jax.random.PRNGKey(1)))
    n = treedef.num_leaves
    params = jax.tree_util.tree_unflatten(treedef, [ref[f"p_{i}"] for i in range(n)])
    want = jax.tree_util.tree_unflatten(treedef, [ref[f"g_{i}"] for i in range(n)])
    tm = TSolver(TConfig(**SOLVER), device="cpu").double()
    tm.load_state_dict({k: v.double() for k, v in params_from_jax(params).items()})
    X = points()
    terms = diffusion_terms({"res": _Fixed(X["res"], tdd.r), "bc1": _Fixed(X["bc1"], tdd.u),
                             "ics": _Fixed(X["ics"], tdd.u)}, len(X["res"]))
    seen = {}

    def update(grads, state, params):
        seen["g"] = grads
        return [torch.zeros_like(g) for g in grads], state

    opt = topt.GradientTransformation(lambda p: None, update)
    step, _ = make_train_step(tm, get_operator("diffusion", "fwd"), terms, opt,
                              TConfig(solver="CV"), fuse_value_terms=True)
    tparams = [p for p in tm.parameters() if p.requires_grad]
    _, _, metrics = step(tparams, None, topt.plateau_init(), torch.Generator())
    for k in ("loss", "res", "bc", "ic"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[f"m_{k}"]), rtol=2e-5,
                                   err_msg=k)
    for p, g in zip(tparams, seen["g"]):
        p.grad = g
    got = grads_to_jax_layout(tm)
    for a, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-4 * max(np.abs(w).max(), 1e-3))
