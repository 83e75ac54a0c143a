"""The PyTorch port's circuit layer against the JAX package on shared numpy
inputs (CPU): ansatz programs, Haar constants, diagonal fusion, the gate
engine, and the block engine (merged and raw chains)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import ansatz as j_ansatz
from qcpinn_tpu.ops import diag_fusion as j_diag
from qcpinn_tpu.ops import gates as j_gates
from qcpinn_tpu.ops.block_fused import BlockFusedCircuit as JBlock
from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
from qcpinn_tpu_torch.ops import ansatz as t_ansatz
from qcpinn_tpu_torch.ops import diag_fusion as t_diag
from qcpinn_tpu_torch.ops import gates as t_gates
from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit as TBlock
from qcpinn_tpu_torch.ops.circuit import DVCircuit as TCircuit

ANSATZES = sorted(j_ansatz.BUILDERS)


def _ops(program):
    return [(op.kind, op.wires, op.pidx) for op in program]


def _build(mod, name, n):
    try:
        return _ops(mod.build(name, n))
    except (AssertionError, ValueError, IndexError) as e:
        return type(e).__name__


@pytest.mark.parametrize("name", ANSATZES)
def test_ansatz_programs_and_counts(name):
    assert sorted(t_ansatz.BUILDERS) == ANSATZES
    for n in range(2, 9):
        assert _build(t_ansatz, name, n) == _build(j_ansatz, name, n), (name, n)
        assert t_ansatz.PARAM_COUNTS[name](n) == j_ansatz.PARAM_COUNTS[name](n)


def test_reupload_brickwork_program():
    for n in range(2, 9):
        assert _ops(t_ansatz.reupload_cz_brickwork(n, 0)) == _ops(
            j_ansatz.reupload_cz_brickwork(n, 0)
        )


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_haar_constants(seed):
    for a, b in zip(t_gates.haar_2q_pair(seed), j_gates.haar_2q_pair(seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["rx", "ry", "rz", "phase_shift", "crx", "cry", "crz"])
def test_gate_matrices(fn):
    theta = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    got = getattr(t_gates, fn)(torch.as_tensor(theta)).numpy()
    want = np.asarray(getattr(j_gates, fn)(jnp.asarray(theta)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def _runs(program):
    return [op for op in program if not hasattr(op, "kind")]


@pytest.mark.parametrize("n", [4, 5, 12])
def test_diag_runs_phases_and_split(n):
    jc = JCircuit(n, 1, "cross_mesh")
    tc = TCircuit(n, 1, "cross_mesh")
    jr, tr = _runs(jc.program), _runs(tc.program)
    assert len(jr) == len(tr) > 0
    params = np.random.default_rng(n).normal(size=tc.params_per_layer).astype(np.float32)
    for a, b in zip(tr, jr):
        assert (a.pidx, a.quad, a.const_pairs) == (b.pidx, b.quad, b.const_pairs)
        np.testing.assert_array_equal(a.w1, b.w1)
        np.testing.assert_array_equal(a.c1, b.c1)
        np.testing.assert_allclose(
            a.phases(torch.as_tensor(params)).numpy(),
            np.asarray(b.phases(jnp.asarray(params))),
            atol=2e-5, rtol=1e-6,
        )
        for hb in range(1, n):
            ts, js = t_diag.split_diag_run(a, hb), j_diag.split_diag_run(b, hb)
            assert (ts is None) == (js is None)
            if ts is None:
                continue
            for x, y in zip(ts, js):
                assert (x is None) == (y is None)
                if x is not None:
                    assert (x.n, x.pidx, x.quad, x.const_pairs) == (
                        y.n, y.pidx, y.quad, y.const_pairs)
                    np.testing.assert_array_equal(x.w1, y.w1)
                    np.testing.assert_array_equal(x.c1, y.c1)


def _unit_states(rng, b, n):
    s = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    return (s / np.linalg.norm(s, axis=1, keepdims=True)).astype(np.complex64)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("ansatz", ["cross_mesh", "cascade", "layered", "rot_ring"])
def test_dv_circuit_apply_and_dense(n, ansatz):
    jc = JCircuit(n, 2, ansatz, seed=7)
    tc = TCircuit(n, 2, ansatz, seed=7)
    rng = np.random.default_rng(n)
    params = rng.normal(scale=0.5, size=(2, tc.params_per_layer)).astype(np.float32)
    x = rng.uniform(-1, 1, size=(6, n)).astype(np.float32)
    got = tc.apply(torch.as_tensor(params), torch.as_tensor(x)).numpy()
    want = np.asarray(jax.jit(jc.apply)(jnp.asarray(params), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the gate engine against the port's own dense oracle
    st = _unit_states(rng, 3, n)
    evolved = tc.evolve(torch.as_tensor(params), torch.as_tensor(st)).numpy()
    dense = st.astype(np.complex128) @ tc.dense_unitary(params).T
    np.testing.assert_allclose(evolved, dense, atol=1e-5)
    np.testing.assert_allclose(tc.dense_unitary(params), jc.dense_unitary(params), atol=1e-6)


@pytest.mark.parametrize("n", [4, 5, 6])
@pytest.mark.parametrize("merge", [True, False])
def test_block_fused_parity(n, merge):
    jc = JCircuit(n, 1, "cross_mesh", seed=7)
    tc = TCircuit(n, 1, "cross_mesh", seed=7)
    jb, tb = JBlock(jc, merge=merge), TBlock(tc, merge=merge)
    rng = np.random.default_rng(10 + n)
    params = rng.normal(scale=0.5, size=tc.num_params).astype(np.float32)
    x = rng.uniform(-1, 1, size=(5, n)).astype(np.float32)

    pt = torch.tensor(params, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    zt = tb.apply(pt, xt)
    torch.sum(zt**2).backward()

    def value_and_grads(p, xx):
        loss = lambda p2, x2: jnp.sum(jb.apply(p2, x2) ** 2)  # noqa: E731
        return jb.apply(p, xx), jax.grad(loss, argnums=(0, 1))(p, xx)

    zj, gj = jax.jit(value_and_grads)(jnp.asarray(params), jnp.asarray(x))
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj), atol=5e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj[0]), atol=5e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[1]), atol=5e-5)


def test_block_fused_cross_ops_cascade():
    """Boundary-straddling ops (cascade's CRX ring) run as single ops."""
    jc, tc = JCircuit(5, 2, "cascade", seed=3), TCircuit(5, 2, "cascade", seed=3)
    rng = np.random.default_rng(5)
    params = rng.normal(size=tc.num_params).astype(np.float32)
    x = rng.uniform(-1, 1, size=(4, 5)).astype(np.float32)
    for hb in (1, 2, 4):
        got = TBlock(tc, hi_bits=hb).apply(torch.as_tensor(params), torch.as_tensor(x))
        want = jax.jit(JBlock(jc, hi_bits=hb).apply)(jnp.asarray(params), jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


@pytest.mark.parametrize("n", [12, 16])
def test_segment_stats(n):
    tb = TBlock(TCircuit(n, 1, "cross_mesh", seed=42))
    jb = JBlock(JCircuit(n, 1, "cross_mesh", seed=42))
    assert tb.segment_stats() == jb.segment_stats()
    assert tb.segment_stats()["raw"]["segments"] == 5
    assert tb.segment_stats()["merged"]["segments"] == 3
