"""The port's gate-table loop engine (qcpinn_tpu_torch/ops/loop_kernel.py)
against the JAX package's ops/pallas_loop.py: the table lowering, the
gathered kernel inputs, the kernels' plain versions against the Pallas
kernels in interpret mode, and LoopFusedCircuit end to end.

Tolerances are tests/test_pallas_loop.py's: 5e-6 forward, 5e-5 on grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import pallas_loop as jpl
from qcpinn_tpu.ops import statevector as jsv
from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
from qcpinn_tpu_torch.ops import loop_kernel as lk
from qcpinn_tpu_torch.ops import statevector as tsv
from qcpinn_tpu_torch.ops.circuit import DVCircuit as TCircuit


def _pair(ansatz, n, layers=1, encoding="angle", fuse=True):
    kw = dict(num_qubits=n, num_quantum_layers=layers, q_ansatz=ansatz,
              encoding=encoding, seed=7, fuse=fuse)
    return JCircuit(**kw), TCircuit(**kw)


@pytest.mark.parametrize("ansatz,n", [("cross_mesh", 4), ("cross_mesh", 10),
                                      ("cross_mesh", 16), ("cascade", 4)])
def test_table_lowering_matches_jax(ansatz, n):
    jc, tc = _pair(ansatz, n)
    jlp, tlp = jpl.compile_loop_program(jc), lk.compile_loop_program(tc)
    np.testing.assert_array_equal(tlp.table, jlp.table)
    np.testing.assert_array_equal(tlp.u4_bank, jlp.u4_bank)
    assert (tlp.num_mats, tlp.num_phases, tlp.hi, tlp.lo) == (
        jlp.num_mats, jlp.num_phases, jlp.hi, jlp.lo)


def test_step_words_decode_the_wires():
    """The CUDA table: bit g = n-1-w of each wire, whatever axis the JAX
    table put it on; 16q cross_mesh has 33 mats, 2 diag runs, 2 u2q."""
    _, tc = _pair("cross_mesh", 16)
    lp = lk.compile_loop_program(tc)
    st = lk.steps(lp)
    assert [s.kind for s in st].count(lk.K_MAT) == 33 == lp.num_mats
    assert [s.kind for s in st].count(lk.K_DIAG) == 2 == lp.num_phases
    u2q = [s for s in st if s.kind == lk.K_U2Q]
    assert [(s.ga, s.gb) for s in u2q] == [(15, 14), (13, 12)]  # wires (0,1), (2,3)
    assert st[-1].kind == lk.K_MAT and st[-1].ga == 0  # H on the last wire
    words = lk.step_words(lp)
    assert words.dtype == np.uint32 and len(words) == len(st)
    assert [int(w) & 3 for w in words] == [s.kind for s in st]
    assert [(int(w) >> 2) & 31 for w in words] == [s.ga for s in st]
    assert [int(w) >> 16 for w in words] == [s.idx for s in st]
    _, cas = _pair("cascade", 10)
    ctrl = [s for s in lk.steps(lk.compile_loop_program(cas)) if s.ctrl and s.kind == lk.K_MAT]
    assert ctrl and all(s.ga != s.gb for s in ctrl)


@pytest.mark.parametrize("ansatz,n,atol", [("cross_mesh", 4, 1e-6), ("rot_ring", 4, 1e-6),
                                           ("cross_mesh", 16, 5e-5)])
def test_gathered_inputs_match_jax(ansatz, n, atol):
    """mats8 exactly as built; the phase planes within float32 rounding of
    phases that sum up to 256 angles at 16 qubits (|phi| reaches tens, so
    one ulp of phi is ~2e-6 and the matmul order differs between XLA and
    torch). rot_ring covers the three-angle Rot gates."""
    jc, tc = _pair(ansatz, n)
    jlp, tlp = jpl.compile_loop_program(jc), lk.compile_loop_program(tc)
    p = np.random.default_rng(0).normal(size=jc.num_params).astype(np.float32)
    want = jpl.gather_scalar_inputs(jc, jlp, jnp.asarray(p))
    got = lk.gather_scalar_inputs(tc, tlp, torch.tensor(p))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    for a, w in zip(got[1:], want[1:]):
        assert tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=atol)


def _kernel_inputs(jc, tc, b, seed=0):
    jlp, tlp = jpl.compile_loop_program(jc), lk.compile_loop_program(tc)
    rng = np.random.default_rng(seed)
    p = rng.normal(size=jc.num_params).astype(np.float32)
    x = rng.normal(size=(4, b, jlp.hi, jlp.lo)).astype(np.float32)
    nrm = np.sqrt((x[0] ** 2 + x[1] ** 2).sum(axis=(1, 2), keepdims=True))
    x[0], x[1] = x[0] / nrm, x[1] / nrm
    return jlp, tlp, p, x


@pytest.mark.parametrize("ansatz,fuse", [("cross_mesh", True), ("cascade", True),
                                         ("cascade", False)])
def test_plain_kernels_match_the_pallas_kernels(ansatz, fuse):
    """loop_fwd_ref / loop_bwd_ref against make_loop_state_fn(interpret=True)
    at n = 4, B = 5 (the Pallas call takes whole tiles: zero rows pad the
    batch and add nothing to the batch sums). ``fuse=False`` leaves no
    phase bank: its cotangents come back as zeros, as in JAX."""
    b = 5
    jc, tc = _pair(ansatz, 4, fuse=fuse)
    jlp, tlp, p, x = _kernel_inputs(jc, tc, b)
    jm, jcos, jsin = jpl.gather_scalar_inputs(jc, jlp, jnp.asarray(p))
    tm, tcos, tsin = lk.gather_scalar_inputs(tc, tlp, torch.tensor(p))
    tb = jpl._tile_rows(jlp)

    def pad(a):
        return jnp.asarray(np.concatenate([a, np.zeros((tb - b,) + a.shape[1:], np.float32)]))

    f = jpl.make_loop_state_fn(jlp, interpret=True)
    y, vjp = jax.vjp(f, pad(x[0]), pad(x[1]), jm, jcos, jsin)
    want_g = vjp((pad(x[2]), pad(x[3])))
    u4 = torch.tensor(tlp.u4_bank)
    lk.reset_launches()
    got_y = lk.gate_loop_fwd(torch.tensor(x[0]), torch.tensor(x[1]), tm, u4, tcos, tsin, tlp)
    for a, w in zip(got_y, y):
        np.testing.assert_allclose(a.numpy(), np.asarray(w)[:b], atol=5e-6)
    got_g = lk.gate_loop_bwd(*got_y, torch.tensor(x[2]), torch.tensor(x[3]), tm, u4,
                             tcos, tsin, tlp)
    assert lk.LAUNCHES["gate_loop_fwd_ref"] == 1 and lk.LAUNCHES["gate_loop_bwd_ref"] == 1
    for i, (a, w) in enumerate(zip(got_g, want_g)):
        w = np.asarray(w)[:b] if i < 2 else np.asarray(w)
        assert a.shape == w.shape, i
        np.testing.assert_allclose(a.numpy(), w, atol=5e-5)
    if not fuse:
        assert tlp.num_phases == 0 and not got_g[3].any() and not got_g[4].any()


def test_reduce_ref_sums_in_slab_order():
    parts = torch.tensor(np.random.default_rng(1).normal(size=(7, 33)), dtype=torch.float32)
    out = lk.gate_loop_reduce(parts)
    want = parts[0].clone()
    for k in range(1, 7):
        want += parts[k]
    assert torch.equal(out, want)


@pytest.mark.parametrize("ansatz", ["cross_mesh", "cascade"])
def test_loop_fused_circuit_matches_jax(ansatz):
    """apply and its grads in params and inputs against the JAX
    LoopFusedCircuit (interpret mode), as tests/test_pallas_loop.py holds
    the JAX one against the circuit."""
    jc, tc = _pair(ansatz, 4)
    jlf, tlf = jpl.LoopFusedCircuit(jc, interpret=True), lk.LoopFusedCircuit(tc)
    rng = np.random.default_rng(2)
    p = rng.normal(size=jc.num_params).astype(np.float32)
    x = rng.uniform(-1, 1, size=(5, 4)).astype(np.float32)
    z_ref = jlf.apply(jnp.asarray(p), jnp.asarray(x))
    g_ref = jax.grad(lambda pp, xx: jnp.sum(jlf.apply(pp, xx) ** 2), argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(x))
    tp = torch.tensor(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    z = tlf.apply(tp, tx)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref), atol=5e-6)
    torch.sum(z**2).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g_ref[0]), atol=5e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_ref[1]), atol=5e-5)
    # and the port's own gate-by-gate circuit
    np.testing.assert_allclose(z.detach().numpy(), tc.apply(tp, tx).detach().numpy(),
                               atol=5e-6)


def test_loop_evolve_arbitrary_state():
    jc, tc = _pair("cross_mesh", 4)
    p = np.random.default_rng(3).normal(size=jc.num_params).astype(np.float32)
    rng = np.random.RandomState(3)
    st = rng.randn(4, 16) + 1j * rng.randn(4, 16)
    st = (st / np.linalg.norm(st, axis=1, keepdims=True)).astype(np.complex64)
    want = jpl.LoopFusedCircuit(jc, interpret=True).evolve(jnp.asarray(p), jnp.asarray(st))
    got = lk.LoopFusedCircuit(tc).evolve(torch.tensor(p), torch.tensor(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


def test_amplitude_encoding_matches_jax():
    x = (np.random.default_rng(4).uniform(size=(5, 3)) + 0.1).astype(np.float32)
    np.testing.assert_allclose(tsv.encode_amplitude(torch.tensor(x), 4).numpy(),
                               np.asarray(jsv.encode_amplitude(jnp.asarray(x), 4)),
                               atol=1e-7)
    jc, tc = _pair("cascade", 4, encoding="amplitude")
    p = np.random.default_rng(5).normal(size=jc.num_params).astype(np.float32)
    want = jpl.LoopFusedCircuit(jc, interpret=True).apply(jnp.asarray(p), jnp.asarray(x))
    got = lk.LoopFusedCircuit(tc).apply(torch.tensor(p), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jc.apply(jnp.asarray(p), jnp.asarray(x))),
                               atol=5e-6)
    with pytest.raises(ValueError, match="do not fit"):
        tsv.encode_amplitude(torch.zeros(2, 17), 4)


def test_batched_params_rejected_and_constants_cached():
    _, tc = _pair("cascade", 4)
    lf = lk.LoopFusedCircuit(tc)
    with pytest.raises(ValueError, match="unbatched"):
        lf.evolve(torch.zeros(4, tc.num_params), tsv.zero_state(4, 4))
    assert lf.constants("cpu") is lf.constants(torch.device("cpu"))
