"""The port's unrolled micro-program engine (qcpinn_tpu_torch/ops/sv_kernel.py)
against the JAX package's ops/pallas_sv.py: the lowering, the gathered
kernel inputs, the kernels' plain versions against the Pallas kernels in
interpret mode, and FusedCircuit end to end.

Tolerances are tests/test_pallas_sv.py's: 3e-5 forward, 2e-4 on grads
(3e-5 for the amplitude-encoded grads). The Pallas kernels in interpret
mode take tens of seconds to trace a whole circuit on this CPU, so they
are held against the plain versions on one short program that has every
step kind; FusedCircuit end to end is held against the JAX circuit, as
tests/test_pallas_sv.py holds the JAX FusedCircuit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import gates as jgates
from qcpinn_tpu.ops import pallas_sv as jps
from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
from qcpinn_tpu_torch.ops import loop_kernel as lk
from qcpinn_tpu_torch.ops import sv_kernel as sk
from qcpinn_tpu_torch.ops.circuit import DVCircuit as TCircuit

CIRCUITS = {  # (ansatz, n, layers, seed)
    "cross_mesh": ("cross_mesh", 4, 1, 7),
    "cascade_haar": ("cascade", 4, 1, 11),  # c1q steps and a Haar u2q epilogue
    "layered_3": ("layered", 4, 3, None),
}


def _pair(ansatz, n, layers=1, seed=None, encoding="angle", fuse=True):
    kw = dict(num_qubits=n, num_quantum_layers=layers, q_ansatz=ansatz,
              encoding=encoding, seed=seed, fuse=fuse)
    return JCircuit(**kw), TCircuit(**kw)


def _bank(u4s):
    """[U, 32] re/im rows of fixed 4x4s (the kernels' u4 layout)."""
    bank = np.zeros((max(len(u4s), 1), 32), np.float32)
    for k, u in enumerate(u4s):
        bank[k, 0::2], bank[k, 1::2] = np.real(u).reshape(16), np.imag(u).reshape(16)
    return bank


@pytest.mark.parametrize("include_encoding", [True, False])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_compile_circuit_matches_jax(name, include_encoding):
    """Step lists, bank counts and u4 constants equal JAX's, and the gate
    table the engine takes its constants from carries the same u4 bank."""
    jc, tc = _pair(*CIRCUITS[name])
    jmp = jps.compile_circuit(jc, include_encoding)
    tmp = sk.compile_circuit(tc, include_encoding)
    assert [dataclasses.astuple(s) for s in tmp.steps] == [
        dataclasses.astuple(s) for s in jmp.steps]
    assert (tmp.n, tmp.num_mats, tmp.num_phases) == (jmp.n, jmp.num_mats, jmp.num_phases)
    assert len(tmp.u4s) == len(jmp.u4s)
    for a, w in zip(tmp.u4s, jmp.u4s):
        np.testing.assert_array_equal(a, w)
    np.testing.assert_array_equal(lk.compile_loop_program(tc).u4_bank, _bank(jmp.u4s))
    if name == "cascade_haar":
        assert {s.kind for s in tmp.steps} == {"1q", "c1q", "diag", "u2q"}


def test_encoding_program_refuses_what_jax_refuses():
    for enc in ("angle_pi", "amplitude"):
        _, tc = _pair("cascade", 3, encoding=enc)
        with pytest.raises(ValueError, match="angle encoding"):
            sk.compile_circuit(tc)
        assert sk.compile_circuit(tc, include_encoding=False).num_mats > 0


@pytest.mark.parametrize("ansatz,fuse,with_x", [
    ("cross_mesh", True, True), ("cross_mesh", True, False),
    ("rot_ring", True, True), ("cascade", False, True)])
def test_gather_inputs_match_jax(ansatz, fuse, with_x):
    """The per-sample encoding RX bank, the broadcast ansatz gates and the
    phase rows; ``fuse=False`` leaves an empty phase bank, rot_ring has
    three-angle Rot gates."""
    jc, tc = _pair(ansatz, 4, seed=7, fuse=fuse)
    jmp, tmp = jps.compile_circuit(jc, with_x), sk.compile_circuit(tc, with_x)
    rng = np.random.default_rng(0)
    p = rng.normal(size=jc.num_params).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, size=(5, 4)).astype(np.float32)
    want = jps.gather_inputs(jc, jmp, jnp.asarray(p), jnp.asarray(x) if with_x else None,
                             batch=5)
    got = sk.gather_inputs(tc, tmp, torch.tensor(p), torch.tensor(x) if with_x else None,
                           batch=5)
    for a, w in zip(got, want):
        assert tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6)
    if not fuse:
        assert got[2].shape == (0, 16)


def _short_program(jax_side: bool):
    """n = 3: every step kind, a control above and below its target, and a
    u2q with ctrl > wire."""
    mod = jps if jax_side else sk
    s = mod.Step
    steps = (s("1q", wire=0, mat=0), s("c1q", ctrl=1, wire=2, mat=1),
             s("diag", phase=0), s("u2q", ctrl=2, wire=0, u4=0),
             s("c1q", ctrl=2, wire=0, mat=2), s("u2q", ctrl=0, wire=1, u4=1),
             s("diag", phase=1), s("1q", wire=1, mat=3))
    haar = jgates.haar_2q_pair(3)[0]
    return mod.MicroProgram(3, steps, 4, 2, (jgates.CZ, haar))


def _unitaries(rng, shape):
    a = rng.normal(size=shape + (2, 2)) + 1j * rng.normal(size=shape + (2, 2))
    q, r = np.linalg.qr(a)
    return (q * (np.diagonal(r, axis1=-2, axis2=-1) / np.abs(
        np.diagonal(r, axis1=-2, axis2=-1)))[..., None, :]).astype(np.complex64)


def test_plain_kernels_match_the_pallas_kernels():
    """unrolled_fwd_ref / unrolled_bwd_ref against
    make_fused_state_fn(interpret=True) on per-sample unitaries, B = 8 (one
    Pallas tile, so no padding)."""
    b = 8
    jmp, tmp = _short_program(True), _short_program(False)
    rng = np.random.default_rng(1)
    m = _unitaries(rng, (b, 4))
    phi = rng.normal(size=(2, 8)).astype(np.float32)
    x = rng.normal(size=(4, b, 8)).astype(np.float32)
    nrm = np.sqrt((x[0] ** 2 + x[1] ** 2).sum(axis=1, keepdims=True))
    x[0], x[1] = x[0] / nrm, x[1] / nrm
    ins = [x[0], x[1], m.real.copy(), m.imag.copy(), np.cos(phi), np.sin(phi)]
    f = jps.make_fused_state_fn(jmp, interpret=True)

    def fwd_bwd(*a):
        y, vjp = jax.vjp(f, *a[:6])
        return y, vjp((a[6], a[7]))

    want_y, want_g = jax.jit(fwd_bwd)(*[jnp.asarray(a) for a in ins + [x[2], x[3]]])
    t = [torch.tensor(a) for a in ins]
    u4 = torch.tensor(_bank(tmp.u4s))
    sk.reset_launches()
    got_y = sk.unrolled_fwd(t[0], t[1], t[2], t[3], t[4], t[5], u4, tmp)
    for a, w in zip(got_y, want_y):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-5)
    got_g = sk.unrolled_bwd(*got_y, torch.tensor(x[2]), torch.tensor(x[3]), t[2], t[3],
                            t[4], t[5], u4, tmp)
    assert sk.LAUNCHES["unrolled_fwd_ref"] == 1 and sk.LAUNCHES["unrolled_bwd_ref"] == 1
    for i, (a, w) in enumerate(zip(got_g, want_g)):
        assert tuple(a.shape) == w.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-4)


def test_reduce_ref_sums_in_slab_order():
    parts = torch.tensor(np.random.default_rng(2).normal(size=(7, 33)), dtype=torch.float32)
    out = sk.unrolled_reduce(parts)
    want = parts[0].clone()
    for k in range(1, 7):
        want += parts[k]
    assert torch.equal(out, want)
    assert sk.LAUNCHES["unrolled_reduce_ref"] >= 1


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_fused_circuit_matches_jax(name):
    """apply and its grads in params and inputs against the JAX circuit."""
    jc, tc = _pair(*CIRCUITS[name])
    fc = sk.FusedCircuit(tc)
    rng = np.random.default_rng(3)
    p = rng.normal(size=jc.num_params).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, size=(5, 4)).astype(np.float32)

    def j_ref(pp, xx):
        g = jax.grad(lambda a, b: jnp.sum(jc.apply(a, b) ** 2), argnums=(0, 1))(pp, xx)
        return jc.apply(pp, xx), g, jc.state(pp, xx)

    z_ref, g_ref, s_ref = jax.jit(j_ref)(jnp.asarray(p), jnp.asarray(x))
    tp = torch.tensor(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    sk.reset_launches()
    z = fc.apply(tp, tx)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref), atol=3e-5)
    torch.sum(z**2).backward()
    assert sk.LAUNCHES["unrolled_fwd_ref"] == 1 and sk.LAUNCHES["unrolled_bwd_ref"] == 1
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g_ref[0]), atol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_ref[1]), atol=2e-4)
    np.testing.assert_allclose(fc.state(tp, tx).detach().numpy(), np.asarray(s_ref),
                               atol=3e-5)


def test_evolve_arbitrary_state_and_grads():
    jc, tc = _pair("cascade", 5, seed=11)
    rng = np.random.default_rng(4)
    p = rng.normal(size=jc.num_params).astype(np.float32)
    st = rng.normal(size=(3, 32)) + 1j * rng.normal(size=(3, 32))
    st = (st / np.linalg.norm(st, axis=1, keepdims=True)).astype(np.complex64)
    w = np.linspace(-1.0, 1.0, 32).astype(np.float32)

    def j_loss(pp, s):
        e = jc.evolve(pp, s)
        return jnp.sum(jnp.abs(e) ** 2 * w) + jnp.sum(jnp.real(e))

    want, g_ref = jax.jit(lambda pp, s: (jc.evolve(pp, s), jax.grad(j_loss)(pp, s)))(
        jnp.asarray(p), jnp.asarray(st))
    tp = torch.tensor(p, requires_grad=True)
    got = sk.FusedCircuit(tc).evolve(tp, torch.tensor(st))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5)
    (torch.sum(got.abs() ** 2 * torch.tensor(w)) + torch.sum(got.real)).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g_ref), atol=2e-4)


def test_amplitude_encoding_forward_and_grads():
    """The case of tests/test_pallas_sv.py::test_fused_amplitude_encoding_
    parity: the prepared state outside the kernel, the evolve-only program
    inside."""
    jc, tc = _pair("cascade", 3, encoding="amplitude")
    fc = sk.FusedCircuit(tc)
    assert fc.mp is None
    rng = np.random.default_rng(5)
    p = rng.normal(size=jc.num_params).astype(np.float32)
    x = (rng.uniform(size=(4, 5)) + 0.1).astype(np.float32)
    want, g_ref = jax.jit(lambda pp, xx: (
        jc.apply(pp, xx), jax.grad(lambda a: jnp.sum(jc.apply(a, xx) ** 2))(pp)))(
        jnp.asarray(p), jnp.asarray(x))
    tp = torch.tensor(p, requires_grad=True)
    z = fc.apply(tp, torch.tensor(x))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want), atol=3e-5)
    torch.sum(z**2).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g_ref), atol=3e-5)


def test_unported_modes_raise_and_constants_cached():
    _, tc = _pair("cross_mesh", 4, seed=7)
    fc = sk.FusedCircuit(tc)
    x = torch.zeros(2, 4)
    p = torch.zeros(tc.num_params)
    # the readout modes are ported (tests/test_torch_measure.py); shots
    # still need a generator
    with pytest.raises(ValueError, match="shots mode needs a PRNG key"):
        fc.apply(p, x, shots=16)
    assert fc.constants("cpu") is fc.constants(torch.device("cpu"))
    assert fc(p, x).shape == (2, 4)
