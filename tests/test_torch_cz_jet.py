"""The Cz model's second-order forward jet: the circuit's
(``CzQuantumLayer.apply(..., tangents=)``) against ``torch.func``'s
jvp-over-jvp of ``apply`` channel by channel, ``Hybrid16QPINN.jet`` against
the nested jvps along r and z, ``physics/jet.py::cz_residuals_jet``'s terms
and gradients against ``cz_residuals_fwd``'s, ``apply`` without tangents
bit-equal to the gate sequence it always ran, and the pretrain step's
choice of residual path. At 4 and 6 qubits, 2 layers, on the CPU."""

import math

import numpy as np
import pytest
import torch

from qcpinn_tpu_torch.data.cz_loader import DataStats
from qcpinn_tpu_torch.models import czochralski as cz
from qcpinn_tpu_torch.ops import gates, measure
from qcpinn_tpu_torch.ops import statevector as sv
from qcpinn_tpu_torch.parallel.mesh import Axis
from qcpinn_tpu_torch.parallel.sharded_sv import ShardedOps
from qcpinn_tpu_torch.physics.jet import cz_residuals_jet
from qcpinn_tpu_torch.physics.operators_fwd import _d2, cz_residuals_fwd
from qcpinn_tpu_torch.train import cz_pipeline as czp

QUBITS = [4, 6]
B = 8
# the real data's pressure_coeff and the reference's Re, Pr, Gr
ARGS = (134128.54054426512, 15.0, 28.463, 8000.0)


def _points(seed=0):
    x = torch.rand((B, 2), generator=torch.Generator().manual_seed(seed))
    x[0, 0] = 0.0  # on the axis, where the residual's clamp of r acts
    return x


def _close(got, want, rel):
    """Within ``rel`` of the largest magnitude of ``want``."""
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), 1e-3)
    assert float((got - want).abs().max()) <= rel * scale


def _circuit(n):
    """A circuit, its weights and a smooth map from (r, z) to its angles."""
    layer = cz.CzQuantumLayer(n, 2)
    gen = torch.Generator().manual_seed(n)
    w = layer.init(gen)
    M, c = torch.randn((2, n), generator=gen), torch.randn(n, generator=gen)
    return layer, w, lambda X: math.pi * torch.tanh(X @ M + c)


@pytest.mark.parametrize("n", QUBITS)
def test_circuit_jet_matches_nested_jvps(n):
    layer, w, angles = _circuit(n)
    x = _points()
    want = [*_d2(lambda X: layer.apply(w, angles(X)), x, 0),
            *_d2(lambda X: layer.apply(w, angles(X)), x, 1)[1:]]
    a, a_r, a_rr = _d2(angles, x, 0)
    _, a_z, a_zz = _d2(angles, x, 1)
    z, tz = layer.apply(w, a, tangents=torch.stack([a_r, a_z, a_rr, a_zz]))
    assert tz.shape == (4, B, n)
    # want: u, u_r, u_rr, u_z, u_zz; the jet: u, then r, z, rr, zz
    for got, ref in zip([z, tz[0], tz[2], tz[1], tz[3]], want):
        _close(got, ref, 2e-6)


@pytest.mark.parametrize("n", QUBITS)
def test_model_jet_matches_nested_jvps(n):
    model = cz.Hybrid16QPINN(n, 2, width=8, remat=False, seed=n, device="cpu")
    x = _points(1)
    u, u_r, u_rr = _d2(model, x, 0)
    _, u_z, u_zz = _d2(model, x, 1)
    out, t = model.jet(x)
    assert out.shape == (B, 5) and t.shape == (4, B, 5)
    for got, ref in zip([out, *t], [u, u_r, u_z, u_rr, u_zz]):
        _close(got, ref, 1e-5)


@pytest.mark.parametrize("n", QUBITS)
@pytest.mark.parametrize("remat", [False, True])
def test_jet_residual_terms_and_gradients_match_nested_jvps(n, remat):
    """At the tolerances that hold the nested jvps to reverse mode
    (test_torch_cz_physics.py::test_rev_and_fwd_agree_and_give_the_same_gradient);
    under remat the jet's segments are checkpointed."""
    model = cz.Hybrid16QPINN(n, 2, width=8, remat=remat, seed=n, device="cpu")
    x = _points(2)
    t_jet, terms_jet = cz_residuals_jet(model, x, *ARGS)
    t_fwd, terms_fwd = cz_residuals_fwd(model, x, *ARGS)
    for k in terms_fwd:
        np.testing.assert_allclose(float(terms_jet[k]), float(terms_fwd[k]), rtol=5e-3, atol=1e-5)
    params = list(model.parameters())
    g_jet = torch.autograd.grad(t_jet, params)
    g_fwd = torch.autograd.grad(t_fwd, params)
    for a, b in zip(g_jet, g_fwd):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= 5e-3 * scale
    assert all(torch.isfinite(g).all() for g in g_jet)
    # the last layer's RZ(omega) changes no <Z>: the jet gives it no gradient
    g_q = g_jet[[k for k, _ in model.named_parameters()].index("q")]
    assert torch.count_nonzero(g_q[-1, :, 2]) == 0 and torch.count_nonzero(g_q[:-1]) > 0


def _gate_by_gate(layer, w, x):
    """The circuit as ``apply`` runs it without tangents: the RY encode by
    4-wire group products on |0...0>, per layer the reupload phase, the Rot
    groups and the brickwork, exact <Z>."""
    n = layer.n
    bits, brick = cz._constants(n, x.device)
    groups = cz._wire_groups(n)
    st = sv.zero_state(x.shape[0], n)
    for w0, k in groups:
        st = cz._apply_wire_group(st, n, w0, cz._kron_chain(
            [gates.ry(x[:, i]) for i in range(w0, w0 + k)]))
    for layer_i in range(layer.layers):
        theta = 0.5 * torch.roll(x, -layer_i, dims=1)
        phi = theta @ bits.T - 0.5 * torch.sum(theta, dim=1, keepdim=True)
        st = st * torch.exp(1j * phi)
        wl = w[layer_i]
        for w0, k in groups:
            st = cz._apply_wire_group(st, n, w0, cz._kron_chain(
                [gates.rot(wl[i, 0], wl[i, 1], wl[i, 2]) for i in range(w0, w0 + k)]))
        st = st * brick[None, :]
    return measure.exact_z(st, n)


@pytest.mark.parametrize("n", QUBITS)
def test_apply_without_tangents_is_the_gate_sequence_bit_for_bit(n):
    layer, w, angles = _circuit(n)
    x = angles(_points(3))
    assert torch.equal(layer.apply(w, x), _gate_by_gate(layer, w, x))
    with pytest.raises(ValueError, match="no shots"):
        layer.apply(w, x, shots=16, key=torch.Generator(), tangents=torch.zeros((4, B, n)))


def _epoch(**cfg):
    rng = np.random.default_rng(0)
    X = rng.uniform(0.05, 1, (2 * B, 2)).astype(np.float32)
    Y = rng.uniform(-0.5, 0.5, (2 * B, 5)).astype(np.float32)
    stats = DataStats(length_scale=1.0, velocity_scale=1.0, pressure_scale=1.0,
                      temp_min=0.0, temp_max=1.0, pressure_coeff=3.0)
    model = cz.Hybrid16QPINN(4, 2, width=8, remat=False, device="cpu")
    sharded = cfg.pop("sharded", False)
    if sharded:
        # the amp-sharded layout of a one-rank amp axis
        axis = Axis("amp", None, (0,), 0, torch.device("cpu"), "gloo")
        model.qlayer.sharded = ShardedOps(4, 0, axis)
    c = czp.CzConfig(n_qubits=4, n_layers=2, batch_size=B, **cfg)
    return czp.make_pretrain_epoch(model, X, Y, stats, c)


@pytest.mark.parametrize("cfg,path", [
    ({}, "jet"),
    ({"physics_mode": "rev"}, "rev"),
    ({"physics_weight": 0.0}, "none"),
    ({"sharded": True}, "jvp"),
], ids=["fwd", "rev", "data_only", "sharded"])
def test_the_pretrain_step_picks_its_residual_path(cfg, path):
    pe = _epoch(**cfg)
    assert pe.residual_path == path
    if path == "jvp":
        with pytest.raises(ValueError, match="amp sharding"):
            pe.model.qlayer.apply(pe.model.q, torch.zeros((B, 4)),
                                  tangents=torch.zeros((4, B, 4)))
