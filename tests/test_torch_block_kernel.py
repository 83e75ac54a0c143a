"""The block-chain kernels' plain PyTorch versions (the CPU side of
qcpinn_tpu_torch/ops/block_kernel.py) against the JAX package's Pallas
kernel pair in interpret mode and its block engine. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import block_pallas as bp
from qcpinn_tpu.ops import measure as j_measure
from qcpinn_tpu.ops.block_fused import BlockFusedCircuit as JBlock
from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
from qcpinn_tpu_torch.ops import block_kernel as bk
from qcpinn_tpu_torch.ops import measure as t_measure
from qcpinn_tpu_torch.ops.circuit import DVCircuit as TCircuit


def _unit_states(rng, b, n):
    s = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    return (s / np.linalg.norm(s, axis=1, keepdims=True)).astype(np.complex64)


def _pair(n, layers=1, ansatz="cross_mesh"):
    # the seeded Haar epilogue on wires 2, 3 straddles the hi/lo cut at n < 7
    seed = 42 if n >= 7 else None
    jc = JCircuit(n, layers, ansatz, seed=seed)
    tc = TCircuit(n, layers, ansatz, seed=seed)
    return jc, tc, bk.BlockKernelCircuit(tc)


@pytest.mark.parametrize("n,layers", [(4, 1), (5, 1), (6, 1), (5, 2), (12, 1), (12, 3)])
def test_build_plan_matches_jax(n, layers):
    jc, tc, eng = _pair(n, layers)
    jplan = bp.BlockPallasCircuit(jc, interpret=True).plan
    tplan = eng.plan
    assert [(s.kind, s.axis, s.idx) for s in tplan.steps] == [
        (s.kind, s.axis, s.idx) for s in jplan.steps]
    assert tplan.mat_srcs == jplan.mat_srcs
    assert tplan.diag_srcs == jplan.diag_srcs
    assert (tplan.n, tplan.hb, tplan.lb) == (jplan.n, jplan.hb, jplan.lb)


def test_supports_classification():
    assert bk.supports(TCircuit(6, 1, "cross_mesh"))
    casc = TCircuit(6, 1, "cascade")
    assert not bk.supports(casc)
    with pytest.raises(ValueError):
        bk.BlockKernelCircuit(casc)


@pytest.mark.parametrize("n,layers", [(4, 1), (5, 1), (6, 1), (5, 2)])
def test_forward_ref_matches_jax(n, layers):
    jc, tc, eng = _pair(n, layers)
    rng = np.random.default_rng(n + 10 * layers)
    params = rng.normal(scale=0.3, size=tc.num_params).astype(np.float32)
    state = _unit_states(rng, 16, n)
    bk.reset_launches()
    got = eng.evolve(torch.as_tensor(params), torch.as_tensor(state)).numpy()
    assert bk.LAUNCHES["block_chain_fwd_ref"] == 1
    assert bk.LAUNCHES["block_chain_fwd"] == 0
    p, s = jnp.asarray(params), jnp.asarray(state)
    want_pallas = jax.jit(bp.BlockPallasCircuit(jc, interpret=True).evolve)(p, s)
    want_block = jax.jit(JBlock(jc).evolve)(p, s)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_block), atol=2e-5)


def _kernel_case(n, b, seed):
    """Unitary mats and phases from a real circuit (packed, as the kernels
    take them), unit-norm states and a random cotangent, as numpy."""
    jc, tc, eng = _pair(n)
    rng = np.random.default_rng(seed)
    params = rng.normal(scale=0.3, size=tc.num_params).astype(np.float32)
    m, p = (t.detach().numpy().copy() for t in eng.kernel_inputs(torch.as_tensor(params)))
    h, l = 1 << eng.plan.hb, 1 << eng.plan.lb
    st = _unit_states(rng, b, n).reshape(b, h, l)
    g = rng.normal(size=(2, b, h, l)).astype(np.float32)
    return jc, eng.plan, m, p, st.real.copy(), st.imag.copy(), g[0], g[1]


@pytest.mark.parametrize("n", [4, 5, 6])
def test_backward_ref_matches_jax_vjp(n):
    jc, plan, m, p, xr, xi, gr, gi = _kernel_case(n, 8, 100 + n)
    T = torch.as_tensor
    yr, yi = bk.block_chain_fwd_ref(T(xr), T(xi), T(m), T(p), plan)
    gxr, gxi, gm, gp = bk.block_chain_bwd_ref(
        yr, yi, T(gr), T(gi), bk.conj_transpose(plan, T(m)), T(p), plan)
    gmats, gphases = bk.unpack(plan, gm, gp)
    mats, phases = bk.unpack(plan, T(m), T(p))

    # JAX: the Pallas kernel pair (interpret mode) through its custom VJP
    jplan = bp.BlockPallasCircuit(jc, interpret=True).plan
    fwd_layout = bp._diag_layouts(jplan)
    jm = tuple((jnp.asarray(a.numpy()), jnp.asarray(b_.numpy())) for a, b_ in mats)

    def orient(a, idx):  # [H, L] -> the JAX step's forward layout
        return a.T if fwd_layout[idx] != ("hi", "lo") else a

    jph = tuple((jnp.asarray(orient(c.numpy(), i)), jnp.asarray(orient(s.numpy(), i)))
                for i, (c, s) in enumerate(phases))
    out, vjp = jax.vjp(
        lambda a, b_, m_, p_: bp._run(jplan, True, a, b_, m_, p_),
        jnp.asarray(xr), jnp.asarray(xi), jm, jph)
    np.testing.assert_allclose(yr.numpy(), np.asarray(out[0]), atol=2e-5)
    np.testing.assert_allclose(yi.numpy(), np.asarray(out[1]), atol=2e-5)
    jgxr, jgxi, jgm, jgp = vjp((jnp.asarray(gr), jnp.asarray(gi)))
    np.testing.assert_allclose(gxr.numpy(), np.asarray(jgxr), atol=3e-5)
    np.testing.assert_allclose(gxi.numpy(), np.asarray(jgxi), atol=3e-5)
    for (a, b_), (c, d) in zip(gmats, jgm):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=3e-5)
        np.testing.assert_allclose(b_.numpy(), np.asarray(d), atol=3e-5)
    for i, ((a, b_), (c, d)) in enumerate(zip(gphases, jgp)):
        np.testing.assert_allclose(a.numpy(), orient(np.asarray(c), i), atol=3e-5)
        np.testing.assert_allclose(b_.numpy(), orient(np.asarray(d), i), atol=3e-5)


@pytest.mark.parametrize("n", [4, 6])
def test_backward_ref_matches_autograd(n):
    """The reverse sweep (input recovery through conj(M)^T) equals torch
    autograd of the plain forward, which stores every intermediate."""
    _, plan, m, p, xr, xi, gr, gi = _kernel_case(n, 6, 200 + n)
    leaves = [torch.tensor(a, requires_grad=True) for a in (xr, xi, m, p)]
    yr, yi = bk.block_chain_fwd_ref(*leaves, plan)
    want = torch.autograd.grad((yr, yi), leaves, (torch.as_tensor(gr), torch.as_tensor(gi)))
    got = bk.block_chain_bwd_ref(
        yr.detach(), yi.detach(), torch.as_tensor(gr), torch.as_tensor(gi),
        bk.conj_transpose(plan, leaves[2].detach()), leaves[3].detach(), plan)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5)


def test_reduce_ref_and_slab_layout():
    rng = np.random.default_rng(0)
    parts = torch.as_tensor(rng.normal(size=(5, 37)).astype(np.float32))
    np.testing.assert_allclose(
        bk.block_chain_reduce_ref(parts).numpy(), parts.numpy().sum(0), atol=1e-6)
    # the step table's offsets, the unpacking and the conj-transpose agree
    # with the packing
    _, plan, m, p, *_ = _kernel_case(6, 1, 3)
    steps, mats_total = bk._step_table(plan)
    assert steps.shape == (len(plan.steps), 3)
    assert m.size == mats_total
    assert p.size == 2 * plan.n_diags * (1 << plan.n)
    mats, phases = bk.unpack(plan, torch.as_tensor(m), torch.as_tensor(p))
    np.testing.assert_array_equal(bk._pack(mats).numpy(), m)
    np.testing.assert_array_equal(bk._pack(phases).numpy(), p)
    for (c, s) in phases:  # unit phases
        np.testing.assert_allclose((c**2 + s**2).numpy(), 1.0, atol=1e-6)
    cts, _ = bk.unpack(plan, bk.conj_transpose(plan, torch.as_tensor(m)), torch.as_tensor(p))
    for (mr, mi), (tr, ti) in zip(mats, cts):
        np.testing.assert_array_equal(tr.numpy(), mr.t().numpy())
        np.testing.assert_array_equal(ti.numpy(), -mi.t().numpy())
    for row, st in zip(steps, plan.steps):
        if st.kind == "mat":
            off = row[2]
            k = plan.mat_dim(st.idx)
            np.testing.assert_array_equal(
                m[off : off + k * k], mats[st.idx][0].reshape(-1).numpy())
        else:
            np.testing.assert_array_equal(
                p[row[2] : row[2] + (1 << plan.n)], phases[st.idx][0].reshape(-1).numpy())


def _one_step_plan(n, hb):
    return bk.KPlan(n, hb, n - hb, (bk.KStep("mat", "hi", 0),), ((0, "hi"),), ())


@pytest.mark.parametrize("n,hb,ok", [
    (12, 6, True), (12, 7, True), (10, 5, True), (11, 6, True),
    (12, 8, False), (12, 2, False), (10, 4, False), (13, 7, False),
])
def test_check_plan_limits(n, hb, ok):
    """The CUDA wrappers refuse a plan the kernels cannot hold: more than
    12 qubits or a block narrower than 32 (the backward's tensor-core
    tiles). Uneven splits within the limits are accepted, and their
    backward fits a CTA's opt-in shared memory on sm_90 (227 KiB)."""
    plan = _one_step_plan(n, hb)
    if ok:
        bk.check_plan(plan)
        assert 0 < bk.bwd_config(plan)[2] <= 227 * 1024
    else:
        with pytest.raises(ValueError):
            bk.check_plan(plan)


def test_smem_bytes_at_12_qubits():
    # the backward: a tile of two samples' four [64, 64] planes and two
    # [64, 64] re/im matrix buffers; a 128-wide block fits one sample and
    # one [128, 128] buffer
    plan = _one_step_plan(12, 6)
    assert bk.bwd_config(plan) == (2, 2, 4 * (2 * 4 * 64 * 64 + 2 * 2 * 64 * 64))
    assert bk.bwd_config(_one_step_plan(12, 7)) == (1, 1, 4 * (4 * 4096 + 2 * 128 * 128))


@pytest.mark.parametrize("n", [4, 6])
def test_evolve_value_and_grad_matches_jax_block(n):
    """value_and_grad through BlockKernelCircuit.evolve wrt circuit params
    and the input state (tests/test_block_pallas.py tolerances)."""
    jc, tc, eng = _pair(n)
    rng = np.random.default_rng(17 + n)
    params = rng.normal(scale=0.3, size=tc.num_params).astype(np.float32)
    st = _unit_states(rng, 16, n)
    w = rng.normal(size=n).astype(np.float32)
    sr, si = st.real.copy(), st.imag.copy()

    pt, srt, sit = (torch.tensor(a, requires_grad=True) for a in (params, sr, si))
    out = eng.evolve(pt, torch.complex(srt, sit))
    loss = torch.sum(torch.as_tensor(w) * torch.mean(t_measure.exact_z(out, n), dim=0))
    loss.backward()

    jb = JBlock(jc)

    def f(p, a, b):
        z = j_measure.exact_z(jb.evolve(p, (a + 1j * b).astype(jnp.complex64)), n, None)
        return jnp.sum(jnp.asarray(w) * jnp.mean(z, axis=0))

    v, g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(params), jnp.asarray(sr), jnp.asarray(si))
    np.testing.assert_allclose(loss.item(), float(v), atol=1e-5)
    for got, want in zip((pt.grad, srt.grad, sit.grad), g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
