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



def test_cluster_smem_mirrors_the_cuda_source():
    """cluster_config's shared bytes a CTA are the CUDA launch_config's
    (bc_floats: the state planes and two staged slabs of BC_STAGE floats,
    the write-back buffer inside the second), and the slabs hold the
    write-back buffer and the deepest slab of the widest tile."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(bk.__file__), "csrc",
                            "block_chain_cluster.cu")).read()
    consts = {k: int(v) for k, v in re.findall(r"#define (BC_\w+) (\d+)", src)}
    assert "return (size_t)planes * NL + 2 * BC_STAGE;" in src
    assert bk._BC_STAGE_FLOATS == 2 * consts["BC_STAGE"]
    assert consts["BC_STAGE"] >= 2 * consts["BC_OUT"]
    # the widest tile's slab (rows padded by 8) is at least one k-step deep
    widest = consts["BC_TMAX"] + consts["BC_TILE"] // consts["BC_TMAX"] + 16
    assert consts["BC_STAGE"] // (2 * widest) >= 8
    plan = bk.BlockKernelCircuit(TCircuit(16, 1, "cross_mesh", seed=42)).plan
    cfg = bk.cluster_config(plan)
    for c, planes, smem in ((cfg.fwd_cluster, 2, cfg.fwd_smem),
                            (cfg.bwd_cluster, 4, cfg.bwd_smem)):
        assert smem == 4 * (planes * (1 << 16) // c + 2 * consts["BC_STAGE"]) <= 232448


# -- the cluster pair's arithmetic: 3xTF32 on the tensor cores ------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounded to nearest with
    ties away from zero (half an ulp added to the magnitude)."""
    u = x.contiguous().numpy().view(np.uint32)
    r = (u & np.uint32(0x80000000)) | (((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000))
                                       & np.uint32(0xFFFFE000))
    return torch.from_numpy(r.view(np.float32))


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b of f32 [.., P, I] and [.., P, J] in 3xTF32: each operand split
    into a TF32 high part and a TF32 low part of the remainder, lo*hi +
    hi*lo + hi*hi accumulated in f32, as the kernel's mma3 does."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    t = lambda x, y: x.transpose(-1, -2) @ y  # noqa: E731
    return (t(al, bh) + t(ah, bl)) + t(ah, bh)


def _cgemm3(ar, ai, br, bi):
    """The kernel's tile GEMM, acc(i, j) = sum_p A(p, i) B(p, j), complex:
    operands zero-padded to whole warp tiles and k-steps (I and J to 32,
    P to 8), the four real products in 3xTF32 (-B_im exact), the padded
    outputs dropped."""
    p, i, j = ar.shape[-2], ar.shape[-1], br.shape[-1]

    def pad(x):
        return torch.nn.functional.pad(x, (0, -x.shape[-1] % 32, 0, -p % 8))

    ar, ai, br, bi = pad(ar), pad(ai), pad(br), pad(bi)
    re = _mm3(ar, br) + _mm3(ai, -bi)
    im = _mm3(ar, bi) + _mm3(ai, br)
    return re[..., :i, :j], im[..., :i, :j]


def _contract3(sr, si, mr, mi, axis):
    """_contract in the kernel's arithmetic: out(x, y) = sum_k M[k][x]
    s(k, y), x along the stepped axis."""
    if axis == "hi":  # s(k, y) = s[b, k, l]
        return _cgemm3(mr, mi, sr, si)
    re, im = _cgemm3(mr, mi, sr.transpose(1, 2), si.transpose(1, 2))
    return re.transpose(1, 2), im.transpose(1, 2)


def _chain_3xtf32(plan, xr, xi, gr, gi, m, p):
    """block_chain_fwd_ref, then block_chain_bwd_ref's sweep from its output,
    with every product (contractions and dM) in the kernel's arithmetic."""
    mats, phases = bk.unpack(plan, m, p)
    sr, si = xr, xi
    for st in plan.steps:
        if st.kind == "mat":
            sr, si = _contract3(sr, si, *mats[st.idx], st.axis)
        else:
            c, s = phases[st.idx]
            sr, si = sr * c - si * s, sr * s + si * c
    yr, yi = sr, si
    matcts, _ = bk.unpack(plan, bk.conj_transpose(plan, m), p)
    qr, qi = gr, gi
    gmats, gphases = [None] * plan.n_mats, [None] * plan.n_diags
    for st in reversed(plan.steps):
        if st.kind == "mat":
            mtr, mti = matcts[st.idx]
            sr, si = _contract3(sr, si, mtr, mti, st.axis)
            # dM[k][m] = sum_y conj s(k, y) g(m, y), a sample at a time
            if st.axis == "hi":  # y along l: A(p = l, i = k)
                a, b = (sr.transpose(1, 2), si.transpose(1, 2)), (qr.transpose(1, 2),
                                                                   qi.transpose(1, 2))
            else:
                a, b = (sr, si), (qr, qi)
            dr, di = _cgemm3(a[0], -a[1], *b)
            gmats[st.idx] = (dr.sum(0), di.sum(0))
            qr, qi = _contract3(qr, qi, mtr, mti, st.axis)
        else:
            c, s = phases[st.idx]
            sr, si = c * sr + s * si, c * si - s * sr
            gphases[st.idx] = (torch.sum(qr * sr + qi * si, dim=0),
                               torch.sum(-qr * si + qi * sr, dim=0))
            qr, qi = c * qr + s * qi, c * qi - s * qr
    return (yr, yi), (qr, qi, bk._pack(gmats), bk._pack(gphases))


@pytest.mark.parametrize("n,hb", [(16, None), (4, 1)])
def test_3xtf32_products_hold_the_chain_limits(n, hb):
    """The cluster pair's arithmetic, emulated on the CPU: every product of
    the chain (K = 256 at 16 qubits) and of its reverse sweep in 3xTF32,
    on JAX's plan and JAX's packed matrices and phases (build_plan,
    _block_unitary), stays within the limits the kernels are held to
    against the plain versions: 2e-5 absolute forward on unit-norm states,
    2e-4 * max|ref| per backward output. n = 4 with hb = 1 pads a 2-wide
    block up to whole MMA tiles."""
    jeng = bp.BlockPallasCircuit(JCircuit(n, 1, "cross_mesh", seed=_seed(n)), hi_bits=hb,
                                 interpret=True)
    eng = bk.BlockKernelCircuit(TCircuit(n, 1, "cross_mesh", seed=_seed(n)), hi_bits=hb)
    plan, jplan = eng.plan, jeng.plan
    assert [(s.kind, s.axis, s.idx) for s in plan.steps] == [
        (s.kind, s.axis, s.idx) for s in jplan.steps]
    assert bk.uses_cluster_pair(plan)
    rng = np.random.default_rng(100 + n)
    params = rng.normal(scale=0.3, size=eng.circuit.num_params).astype(np.float32)
    p2 = jnp.asarray(params).reshape(eng.circuit.layers, -1)
    mats, phases = [], []
    for si, axis in jplan.mat_srcs:
        seg = jeng.segments[si]
        bits, prog = (plan.hb, seg.hi_prog) if axis == "hi" else (plan.lb, seg.lo_prog)
        u = np.asarray(j_block_unitary(bits, prog, p2[seg.layer]))
        mats.append((u.real, u.imag))
    for si in jplan.diag_srcs:
        seg = jeng.segments[si]
        phi = np.asarray(seg.run.phases(p2[seg.layer])).reshape(1 << plan.hb, 1 << plan.lb)
        phases.append((np.cos(phi), np.sin(phi)))
    m = bk._pack([tuple(torch.tensor(a, dtype=torch.float32) for a in pr) for pr in mats])
    p = bk._pack([tuple(torch.tensor(a, dtype=torch.float32) for a in pr)
                  for pr in phases])
    b, h, l = 2, 1 << plan.hb, 1 << plan.lb
    st = _unit_states(rng, b, n).reshape(b, h, l)
    xr, xi = (torch.as_tensor(np.ascontiguousarray(a)) for a in (st.real, st.imag))
    gr, gi = (torch.as_tensor(rng.normal(size=(b, h, l)).astype(np.float32))
              for _ in range(2))

    (yr, yi), bwd = _chain_3xtf32(plan, xr, xi, gr, gi, m, p)
    ref_y = bk.block_chain_fwd_ref(xr, xi, m, p, plan)
    ref = bk.block_chain_bwd_ref(*ref_y, gr, gi, bk.conj_transpose(plan, m), p, plan)
    for got, want in zip((yr, yi), ref_y):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    for got, want in zip(bwd, ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2e-4 * want.abs().max().item())
