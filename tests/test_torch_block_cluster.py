"""The block-chain kernels at every configuration JAX's block_pallas takes:
13-16 qubits and narrow or uneven hi/lo splits, which the cluster pair
(qcpinn_tpu_torch/ops/csrc/block_chain_cluster.cu) runs on the card. Here,
on the CPU, the plan, the packed inputs, the dispatch rule, the cluster
sizing and the plain versions are held against the JAX package; the CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import block_pallas as bp
from qcpinn_tpu.ops import measure as j_measure
from qcpinn_tpu.ops.block_fused import _block_unitary as j_block_unitary
from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
from qcpinn_tpu_torch.ops import block_kernel as bk
from qcpinn_tpu_torch.ops import measure as t_measure
from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
from qcpinn_tpu_torch.ops.circuit import DVCircuit as TCircuit


def _seed(n):
    # the seeded Haar epilogue on wires 2, 3 straddles the hi/lo cut at n < 7
    return 42 if n >= 7 else None


def _unit_states(rng, b, n):
    s = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    return (s / np.linalg.norm(s, axis=1, keepdims=True)).astype(np.complex64)


@pytest.mark.parametrize("n", [13, 14, 15, 16])
def test_plan_and_packed_inputs_match_jax(n):
    """The plan, the step table's offsets, the packed mats (JAX's
    _block_unitary) and phases, and their conj-transpose at 13-16 qubits."""
    jeng = bp.BlockPallasCircuit(JCircuit(n, 1, "cross_mesh", seed=42), interpret=True)
    tc = TCircuit(n, 1, "cross_mesh", seed=42)
    eng = bk.BlockKernelCircuit(tc)
    plan, jplan = eng.plan, jeng.plan
    assert (plan.n, plan.hb, plan.lb) == (jplan.n, jplan.hb, jplan.lb)
    assert [(s.kind, s.axis, s.idx) for s in plan.steps] == [
        (s.kind, s.axis, s.idx) for s in jplan.steps]
    assert plan.mat_srcs == jplan.mat_srcs and plan.diag_srcs == jplan.diag_srcs

    rng = np.random.default_rng(n)
    params = rng.normal(scale=0.3, size=tc.num_params).astype(np.float32)
    with torch.no_grad():
        m, p = eng.kernel_inputs(torch.as_tensor(params))
    steps, mats_total = bk._step_table(plan)
    assert m.numel() == mats_total and p.numel() == 2 * plan.n_diags * (1 << n)
    mats, phases = bk.unpack(plan, m, p)
    p2 = jnp.asarray(params).reshape(tc.layers, -1)
    for idx, (si, axis) in enumerate(plan.mat_srcs):
        seg = jeng.segments[si]
        bits, prog = (plan.hb, seg.hi_prog) if axis == "hi" else (plan.lb, seg.lo_prog)
        want = np.asarray(j_block_unitary(bits, prog, p2[seg.layer]))
        np.testing.assert_allclose(mats[idx][0].numpy(), want.real, atol=1e-6)
        np.testing.assert_allclose(mats[idx][1].numpy(), want.imag, atol=1e-6)
    for idx, si in enumerate(plan.diag_srcs):
        seg = jeng.segments[si]
        phi = np.asarray(seg.run.phases(p2[seg.layer])).reshape(1 << plan.hb, 1 << plan.lb)
        # the phase sums round differently in f32 (tests/test_torch_circuit.py)
        np.testing.assert_allclose(phases[idx][0].numpy(), np.cos(phi), atol=2e-5)
        np.testing.assert_allclose(phases[idx][1].numpy(), np.sin(phi), atol=2e-5)
    for row, st in zip(steps, plan.steps):  # the step table points at each input
        if st.kind == "mat":
            k = plan.mat_dim(st.idx)
            np.testing.assert_array_equal(
                m[row[2] : row[2] + k * k].numpy(), mats[st.idx][0].reshape(-1).numpy())
        else:
            np.testing.assert_array_equal(
                p[row[2] : row[2] + (1 << n)].numpy(), phases[st.idx][0].reshape(-1).numpy())
    cts, _ = bk.unpack(plan, bk.conj_transpose(plan, m), p)
    for (mr, mi), (tr, ti) in zip(mats, cts):
        np.testing.assert_array_equal(tr.numpy(), mr.t().numpy())
        np.testing.assert_array_equal(ti.numpy(), -mi.t().numpy())


@pytest.mark.parametrize("n,hb", [(2, 1), (3, 1), (4, 1), (4, 3)])
def test_narrow_split_matches_jax_pallas(n, hb):
    """The plain versions at blocks 2-8 wide, through BlockKernelCircuit's
    forward and its autograd boundary, against JAX's BlockPallasCircuit in
    interpret mode (tests/test_block_pallas.py tolerances: 2e-5 forward,
    2e-4 * max|ref| on grads)."""
    jeng = bp.BlockPallasCircuit(JCircuit(n, 1, "cross_mesh"), hi_bits=hb, interpret=True)
    tc = TCircuit(n, 1, "cross_mesh")
    eng = bk.BlockKernelCircuit(tc, hi_bits=hb)
    assert bk.uses_cluster_pair(eng.plan)
    rng = np.random.default_rng(10 * n + hb)
    params = rng.normal(scale=0.3, size=tc.num_params).astype(np.float32)
    st = _unit_states(rng, 8, n)
    w = rng.normal(size=n).astype(np.float32)
    sr, si = st.real.copy(), st.imag.copy()

    bk.reset_launches()
    pt, srt, sit = (torch.tensor(a, requires_grad=True) for a in (params, sr, si))
    out = eng.evolve(pt, torch.complex(srt, sit))
    loss = torch.sum(torch.as_tensor(w) * torch.mean(t_measure.exact_z(out, n), dim=0))
    loss.backward()
    assert bk.LAUNCHES["block_chain_fwd_ref"] == 1
    assert bk.LAUNCHES["block_chain_bwd_ref"] == 1

    def f(p, a, b):
        out = jeng.evolve(p, (a + 1j * b).astype(jnp.complex64))
        z = j_measure.exact_z(out, n, None)
        return jnp.sum(jnp.asarray(w) * jnp.mean(z, axis=0)), out

    (v, want), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(params), jnp.asarray(sr), jnp.asarray(si))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(v), atol=1e-5)
    for got, ref in zip((pt.grad, srt.grad, sit.grad), g):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4 * np.abs(ref).max())


def test_13_qubit_refs_match_block_engine_autograd():
    """At 13 qubits, B = 2: the plain forward and reverse sweep (what the
    cluster pair computes) against autograd through the port's own
    BlockFusedCircuit, which the block-engine tests hold against JAX."""
    n = 13
    tc = TCircuit(n, 1, "cross_mesh", seed=42)
    eng = bk.BlockKernelCircuit(tc)
    ref = BlockFusedCircuit(tc)
    rng = np.random.default_rng(13)
    params = rng.normal(scale=0.3, size=tc.num_params).astype(np.float32)
    st = _unit_states(rng, 2, n)
    w = rng.normal(size=n).astype(np.float32)
    grads, outs = [], []
    for e in (eng, ref):
        pt, srt, sit = (torch.tensor(a, requires_grad=True)
                        for a in (params, st.real.copy(), st.imag.copy()))
        out = e.evolve(pt, torch.complex(srt, sit))
        loss = torch.sum(torch.as_tensor(w) * torch.mean(t_measure.exact_z(out, n), dim=0))
        loss.backward()
        outs.append(out.detach().numpy())
        grads.append((pt.grad.numpy(), srt.grad.numpy(), sit.grad.numpy()))
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-5)
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", range(2, 17))
def test_dispatch_rule_and_cluster_sizing(n):
    """Every cross_mesh split JAX's build_plan accepts at n qubits is
    accepted by the port's plan and by check_plan; the 12q pair keeps
    exactly its plans (10 <= n <= 12, both blocks 32-128 wide); the cluster
    pair's partition keeps a CTA's state within 128 KiB, a rank's share of
    a fiber within the 4096-entry write-back buffer and a CTA within
    sm_90's 227 KiB of shared memory, at clusters of at most 8 CTAs."""
    for hb in range(1, n):
        try:
            bp.BlockPallasCircuit(JCircuit(n, 1, "cross_mesh", seed=_seed(n)),
                                  hi_bits=hb, interpret=True)
        except ValueError:
            with pytest.raises(ValueError):
                bk.BlockKernelCircuit(TCircuit(n, 1, "cross_mesh", seed=_seed(n)), hi_bits=hb)
            continue
        plan = bk.BlockKernelCircuit(TCircuit(n, 1, "cross_mesh", seed=_seed(n)),
                                     hi_bits=hb).plan
        bk.check_plan(plan)
        legacy = 10 <= n <= 12 and 5 <= min(hb, n - hb)
        assert bk.uses_cluster_pair(plan) is (not legacy), (n, hb)
        if legacy:
            assert 0 < bk.bwd_config(plan)[2] <= 227 * 1024
            continue
        cfg = bk.cluster_config(plan)
        wide, narrow = max(hb, n - hb), min(hb, n - hb)
        assert cfg.part_hi is (hb >= n - hb)
        for c, planes, smem in ((cfg.fwd_cluster, 2, cfg.fwd_smem),
                                (cfg.bwd_cluster, 4, cfg.bwd_smem)):
            assert c in (1, 2, 4, 8) and (1 << wide) % c == 0
            assert 4 * planes * (1 << n) // c <= 128 * 1024
            assert (1 << wide) // c <= 4096 and (c == 1 or 1 << narrow <= 4096)
            assert smem <= 227 * 1024
            if c > 1:  # the least such power of two
                assert (4 * planes * (1 << n) // (c // 2) > 128 * 1024
                        or (1 << wide) // (c // 2) > 4096)
    if n >= 13:
        bal = bk.BlockKernelCircuit(TCircuit(n, 1, "cross_mesh", seed=42)).plan
        cfg = bk.cluster_config(bal)
        assert (cfg.fwd_cluster, cfg.bwd_cluster) == {
            13: (1, 1), 14: (1, 2), 15: (2, 4), 16: (4, 8)}[n]
