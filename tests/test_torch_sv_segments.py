"""The unrolled kernels' segment plan and tile layout
(qcpinn_tpu_torch/ops/sv_kernel.py: ``segments``, ``step_words``,
``tile_layout``, ``phys``, ``route``, ``tile_smem``, ``tile_config``),
which the tile route (csrc/unrolled_sv.cu, 10 <= n <= 12) walks.

The plan is held to its rules on every program the chip check runs; a
plain torch emulation of the tile route (the state in a swizzled flat
buffer, every segment a gather of each thread's tile, the segment's steps
on the tiles, a scatter back) is held to the plain versions within 1e-6
and to the JAX Pallas kernels in interpret mode within their own limits
(tests/test_pallas_sv.py: 3e-5 forward on unit-norm states, 2e-4 * max|ref|
on every backward output). The Pallas kernels take about 20 s to trace a
4-qubit program on this CPU, so they see one program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcpinn_tpu.ops import pallas_sv as jps
from qcpinn_tpu.ops.circuit import DVCircuit as JCircuit
from qcpinn_tpu_torch.ops import loop_kernel as lk
from qcpinn_tpu_torch.ops import sv_kernel as sk
from qcpinn_tpu_torch.ops.circuit import DVCircuit

# chip_smoke.py's SV_SHAPES programs (n, ansatz, layers, seed, encoding),
# and the 8q and 10q main paths' cross_mesh
PROGRAMS = (
    (7, "cross_mesh", 1, 42, "angle"), (8, "cross_mesh", 1, 42, "angle"),
    (9, "cross_mesh", 1, 42, "angle"), (10, "cross_mesh", 1, 42, "angle"),
    (12, "cross_mesh", 1, 42, "angle"), (8, "cascade", 1, 11, "angle"),
    (8, "layered", 3, 42, "angle"), (8, "cross_mesh", 1, 42, "amplitude"),
    (1, "cross_mesh", 1, 42, "angle"), (2, "cross_mesh", 1, 42, "angle"),
    (3, "cascade", 2, 42, "angle"), (4, "cross_mesh", 1, 42, "angle"),
    (5, "alternate", 1, 42, "angle"), (6, "alternate", 1, 42, "angle"),
    (9, "cascade", 1, 11, "angle"), (12, "cascade", 1, 11, "angle"),
    (12, "layered", 2, 42, "angle"), (12, "alternate", 1, 42, "angle"),
)


def _programs(n, ansatz, layers, seed, encoding):
    eng = sk.FusedCircuit(DVCircuit(n, layers, ansatz, encoding=encoding, seed=seed))
    return [mp for mp in (eng.mp, eng.mp_evolve) if mp is not None]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("spec", PROGRAMS, ids=lambda s: "_".join(map(str, s)))
def test_segments_keep_order_fit_k_bits_and_are_maximal(spec, k):
    """The segments cover the program in order; each holds at most k
    target bits; a segment ends only where the next step would bring a
    (k+1)-th bit, so a diag never ends one."""
    for mp in _programs(*spec):
        table = sk.steps(mp)
        segs = sk.segments(mp, k)
        assert [f for f, _, _ in segs] == [0] + [e for _, e, _ in segs[:-1]]
        assert segs[-1][1] == len(table)
        for first, end, mask in segs:
            bits = {g for st in table[first:end] for g in sk.targets(st)}
            assert mask == sum(1 << g for g in bits) and len(bits) <= k
            if end < len(table):
                nxt = table[end]
                assert nxt.kind != lk.K_DIAG
                assert len(bits | set(sk.targets(nxt))) > k


def test_main_path_segment_counts():
    """The 10q evolve's 25 steps are 9 segments (one barrier each instead
    of one a step), the 10q apply's 35 are 12; 8q: 21 in 7, 29 in 10."""
    counts = {}
    for n in (8, 10):
        eng = sk.FusedCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
        for tag, mp in (("apply", eng.mp), ("evolve", eng.mp_evolve)):
            counts[f"{n}_{tag}"] = (len(mp.steps), len(sk.segments(mp)))
    assert counts == {"8_apply": (29, 10), "8_evolve": (21, 7),
                      "10_apply": (35, 12), "10_evolve": (25, 9)}


@pytest.mark.parametrize("spec", [(10, "cross_mesh", 1, 42, "angle"),
                                  (8, "cascade", 1, 11, "angle"),
                                  (12, "cross_mesh", 1, 42, "angle")],
                         ids=lambda s: f"{s[1]}_{s[0]}")
def test_segment_flag_leaves_the_gate_loop_words_unchanged(spec):
    """Bit 13 marks each segment's last step and nothing else; the other
    bits are the gate table's words, and gate_loop's own tables never set
    it."""
    for mp in _programs(*spec):
        words = sk.step_words(mp)
        plain = lk.pack_steps(sk.steps(mp))
        np.testing.assert_array_equal(words & ~np.uint32(sk.SEG_END), plain)
        ends = {e - 1 for _, e, _ in sk.segments(mp)}
        assert {i for i, w in enumerate(words) if w & sk.SEG_END} == ends
        assert not words.flags.writeable
    lp = lk.compile_loop_program(DVCircuit(spec[0], spec[2], spec[1], seed=spec[3]))
    assert not np.any(lk.step_words(lp) & np.uint32(sk.SEG_END))


def _tiles(n, mask, k):
    """[T, 2^k] amplitude indices of each thread's tile, thread t's bits
    deposited as tile_layout says."""
    tile, order = sk.tile_layout(n, mask, k)
    t = torch.arange(1 << (n - k))
    base = sum(((t >> q) & 1) << g for q, g in enumerate(order))
    j = torch.arange(1 << k)
    off = sum(((j >> b) & 1) << g for b, g in enumerate(tile))
    return base[:, None] | off[None, :], tile


@pytest.mark.parametrize("n,k", [(4, 2), (5, 2), (7, 2), (10, 3), (11, 3), (12, 3)])
def test_tile_layout_partitions_the_state(n, k):
    """For every target mask of up to k bits, the tiles cover each
    amplitude once, a tile spans exactly the tile bits, and the mask's
    bits are among them; phys is a bijection that is its own inverse."""
    d = 1 << n
    i = torch.arange(d)
    assert torch.equal(sk.phys(sk.phys(i)), i)
    assert torch.equal(torch.sort(sk.phys(i)).values, i)
    rng = np.random.default_rng(n)
    for _ in range(20):
        bits = rng.choice(n, size=rng.integers(0, k + 1), replace=False)
        mask = int(sum(1 << int(g) for g in bits))
        idx, tile = _tiles(n, mask, k)
        assert len(tile) == k and mask & ~sum(1 << g for g in tile) == 0
        assert torch.equal(torch.sort(idx.flatten()).values, i)
        span = sum(1 << g for g in tile)
        assert torch.all((idx ^ idx[:, :1]) & ~span == 0)


@pytest.mark.parametrize("n", [10, 11, 12])
def test_tile_loads_hit_every_bank(n):
    """On the main paths' programs each warp's tile load (one register j
    for 32 lanes) falls on 32 distinct shared-memory banks."""
    eng = sk.FusedCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
    for mp in (eng.mp, eng.mp_evolve):
        for _, _, mask in sk.segments(mp):
            idx, _ = _tiles(n, mask, sk.TILE_BITS)
            banks = sk.phys(idx).view(-1, 32, 1 << sk.TILE_BITS) % 32  # [warp, lane, j]
            for w in range(banks.shape[0]):
                for j in range(banks.shape[2]):
                    assert len(set(banks[w, :, j].tolist())) == 32


def test_route_by_qubits(monkeypatch):
    """Both directions take the warp route at n <= 9 and the tile route at
    10-12, through route(); the tile route needs 32 threads a CTA."""
    assert [sk.route(n) for n in range(1, 13)] == ["warp"] * 9 + ["tile"] * 3
    assert sk.TILE_MIN_QUBITS == sk.TILE_BITS + 5 <= sk.WARP_MAX_QUBITS + 1
    seen = []
    for name in ("unrolled_fwd_warp", "unrolled_fwd_tile"):
        monkeypatch.setattr(sk, name, lambda *a, _n=name: seen.append(_n))
    monkeypatch.setattr(sk, "_on_cpu", lambda t: False)
    for n in (1, 9, 10, 12):
        mp = sk.compile_circuit(DVCircuit(n, 1, "cross_mesh", seed=42))
        sk.unrolled_fwd(*[None] * 7, mp)
    assert seen == ["unrolled_fwd_warp"] * 2 + ["unrolled_fwd_tile"] * 2
    assert sk._LIB is None


def test_tile_smem_and_launch_choice(monkeypatch):
    """tile_smem mirrors unrolled_tile_body's layout; tile_config stages
    the phase rows and the slab while they fit (the slab first), one tile
    a thread, a grid no larger than the batch or what the SMs hold."""
    d = 1 << 10
    want = 4 * (8 * 9 + 25 + 4 * d + 8 * 21 + 2 * 2 * d + 2 * 2 * d + 4 * 8 * 21 + 32 * 2)
    assert sk.tile_smem(10, 21, 2, 2, 9, 25, True, True, True) == want
    assert sk.tile_smem(10, 21, 2, 2, 9, 25, False, True, False) == 4 * (
        8 * 9 + 25 + 2 * d + 8 * 21 + 2 * 2 * d + 32 * 2)
    seen = []

    def blocks(dev, route, bwd, variant, n, threads, smem):
        seen.append((variant, threads, smem))
        return 4

    monkeypatch.setattr(sk, "_blocks", blocks)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    dev = torch.device("cuda", 0)
    mp = sk.FusedCircuit(DVCircuit(10, 1, "cross_mesh", seed=42)).mp_evolve
    cfg = sk.tile_config(dev, mp, 21, 2, 2, 1536, True)
    assert (cfg.threads, cfg.grid, cfg.rows, cfg.slab, cfg.variant) == (128, 528, True, True, 3)
    assert sk.tile_config(dev, mp, 21, 2, 2, 425, False).grid == 425
    # 12 qubits, 40 phase rows: neither rows nor slab fit, the slab's sums
    # go to the partials
    mp12 = sk.FusedCircuit(DVCircuit(12, 1, "cross_mesh", seed=42)).mp_evolve
    cfg = sk.tile_config(dev, mp12, 25, 40, 2, 37, True)
    assert (cfg.threads, cfg.rows, cfg.slab, cfg.variant) == (512, False, False, 0)
    assert cfg.smem <= sk.SMEM_MAX


# -- the tile route, emulated in plain torch ---------------------------------------


def _phase(cos, sin):
    return torch.complex(cos, sin)


def _mats(mre, mim):
    return torch.complex(mre, mim)  # [B, K, 2, 2]


def _tile_step(v, st, gm, mats, ph, u4c, tile, base, idx, inverse):
    """One step on the tiles v [B, T, R] (complex), the tile bits ``tile``,
    thread bases ``base`` [T] and indices ``idx`` [T, R]: a mat (the pair
    across its tile register bit, selected by its control bit), a diag (the
    phase row at each amplitude's index) or a u2q."""
    r = torch.arange(v.shape[-1])
    if st.kind == lk.K_MAT:
        l = tile.index(st.ga)
        m = mats[:, st.idx]
        if inverse:
            m = m.conj().transpose(-1, -2)
        on = ((idx >> st.gb) & 1).bool() if st.ctrl else torch.ones_like(idx, dtype=torch.bool)
        lo = r[(r >> l) & 1 == 0]
        hi = lo | (1 << l)
        x0, x1 = v[..., lo], v[..., hi]
        m = m[:, None, None]
        y = v.clone()
        y[..., lo] = torch.where(on[:, lo], m[..., 0, 0] * x0 + m[..., 0, 1] * x1, x0)
        y[..., hi] = torch.where(on[:, hi], m[..., 1, 0] * x0 + m[..., 1, 1] * x1, x1)
        return y, on
    if st.kind == lk.K_DIAG:
        p = ph[st.idx][idx]
        return v * (p.conj() if inverse else p), None
    la, lb = tile.index(st.ga), tile.index(st.gb)
    q = r[((r >> la) & 1 == 0) & ((r >> lb) & 1 == 0)]
    quad = [q, q | (1 << lb), q | (1 << la), q | (1 << la) | (1 << lb)]
    u = u4c[st.idx]
    if inverse:
        u = u.conj().T
    y = v.clone()
    for e in range(4):
        y[..., quad[e]] = sum(u[e, c] * v[..., quad[c]] for c in range(4))
    return y, None


def _emulate(mp, k, xr, xi, mre, mim, cos, sin, u4, gr=None, gi=None):
    """The tile route on the CPU: forward from x, or (with g) the reverse
    sweep from the final state x with cotangent g, segment by segment
    through a flat buffer in the kernel's swizzled layout. Returns the
    forward's (yr, yi) or the backward's (gxr, gxi, gmre, gmim, gcos,
    gsin) as unrolled_*_ref does."""
    n, b = mp.n, xr.shape[0]
    bwd = gr is not None
    table = sk.steps(mp)
    mats, ph = _mats(mre, mim), _phase(cos, sin)
    u4c = torch.complex(u4[:, 0::2], u4[:, 1::2]).reshape(-1, 4, 4)
    p = sk.phys(torch.arange(1 << n))
    planes = [torch.complex(xr, xi)] + ([torch.complex(gr, gi)] if bwd else [])
    smem = [torch.empty_like(t) for t in planes]
    for s, t in zip(smem, planes):
        s[:, p] = t
    gm = torch.zeros_like(mats)
    gph = torch.zeros_like(ph)
    segs = sk.segments(mp, k)
    for first, end, mask in (reversed(segs) if bwd else segs):
        idx, tile = _tiles(n, mask, k)
        base = idx[:, 0]
        v = [s[:, sk.phys(idx)] for s in smem]  # [B, T, R]
        for i in (range(end - 1, first - 1, -1) if bwd else range(first, end)):
            st = table[i]
            v0, on = _tile_step(v[0], st, gm, mats, ph, u4c, tile, base, idx, bwd)
            if bwd:
                g = v[1]
                if st.kind == lk.K_MAT:
                    l = tile.index(st.ga)
                    r = torch.arange(v0.shape[-1])
                    lo = r[(r >> l) & 1 == 0]
                    pair = (lo, lo | (1 << l))
                    for i_ in range(2):
                        for j_ in range(2):
                            term = g[..., pair[i_]] * v0[..., pair[j_]].conj()
                            gm[:, st.idx, i_, j_] += torch.where(
                                on[:, pair[i_]], term, 0).sum(dim=(1, 2))
                elif st.kind == lk.K_DIAG:
                    gph[st.idx].index_add_(0, idx.flatten(),
                                           (g * v0.conj()).sum(dim=0).flatten())
                g, _ = _tile_step(g, st, gm, mats, ph, u4c, tile, base, idx, True)
                v = [v0, g]
            else:
                v = [v0]
        for s, t in zip(smem, v):
            s[:, sk.phys(idx)] = t
    out = [s[:, p] for s in smem]
    if not bwd:
        return out[0].real, out[0].imag
    gx = out[1]
    return (gx.real, gx.imag, gm.real, gm.imag, gph.real, gph.imag)


def _inputs(mp, b, seed):
    """Unit-norm states and cotangents, per-sample unitaries, phase rows."""
    rng = np.random.default_rng(seed)
    d, k, p = 1 << mp.n, max(mp.num_mats, 1), max(mp.num_phases, 1)
    a = rng.normal(size=(b, k, 2, 2)) + 1j * rng.normal(size=(b, k, 2, 2))
    q, r = np.linalg.qr(a)
    diag = np.diagonal(r, axis1=-2, axis2=-1)
    m = (q * (diag / np.abs(diag))[..., None, :]).astype(np.complex64)
    x = rng.normal(size=(4, b, d)).astype(np.float32)
    for i in (0, 2):
        nrm = np.sqrt((x[i] ** 2 + x[i + 1] ** 2).sum(axis=1, keepdims=True))
        x[i], x[i + 1] = x[i] / nrm, x[i + 1] / nrm
    phi = rng.uniform(-np.pi, np.pi, size=(p, d)).astype(np.float32)
    bank = np.zeros((max(len(mp.u4s), 1), 32), np.float32)
    for j, u in enumerate(mp.u4s):
        bank[j, 0::2], bank[j, 1::2] = np.real(u).reshape(16), np.imag(u).reshape(16)
    return [torch.tensor(v) for v in (x[0], x[1], x[2], x[3], m.real.copy(), m.imag.copy(),
                                      np.cos(phi), np.sin(phi), bank)]


@pytest.mark.parametrize("n,ansatz,k", [(4, "cross_mesh", 2), (5, "alternate", 2),
                                        (6, "cascade", 2), (7, "cross_mesh", 2),
                                        (10, "cross_mesh", 3)])
def test_tile_emulation_matches_the_plain_versions(n, ansatz, k):
    """Segment by segment, tile by tile, the forward and the reverse sweep
    equal unrolled_fwd_ref / unrolled_bwd_ref within 1e-6 on the apply
    (with the encoding) and the evolve programs (cascade: c1q steps with
    controls inside and outside the tile; alternate: u2q steps)."""
    eng = sk.FusedCircuit(DVCircuit(n, 1, ansatz, seed=11 if ansatz == "cascade" else 42))
    for mp in (eng.mp, eng.mp_evolve):
        xr, xi, gr, gi, mre, mim, cos, sin, u4 = _inputs(mp, 3, n)
        y = sk.unrolled_fwd_ref(xr, xi, mre, mim, cos, sin, u4, mp)
        got = _emulate(mp, k, xr, xi, mre, mim, cos, sin, u4)
        for a, w in zip(got, y):
            torch.testing.assert_close(a, w, atol=1e-6, rtol=0)
        want = sk.unrolled_bwd_ref(*y, gr, gi, mre, mim, cos, sin, u4, mp)
        got = _emulate(mp, k, *y, mre, mim, cos, sin, u4, gr, gi)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=1e-6, rtol=0)


def test_tile_emulation_matches_the_pallas_kernels():
    """The emulated tile route against make_fused_state_fn(interpret=True)
    at 4 qubits, k = 2, B = 8 (one Pallas tile, no padding): the evolve
    program's forward within 3e-5 and every backward output within 2e-4 *
    max|ref|."""
    kw = dict(num_qubits=4, num_quantum_layers=1, q_ansatz="cross_mesh", seed=42)
    jmp = jps.compile_circuit(JCircuit(**kw), False)
    mp = sk.compile_circuit(DVCircuit(4, 1, "cross_mesh", seed=42), include_encoding=False)
    assert len(sk.segments(mp, 2)) > 1
    xr, xi, gr, gi, mre, mim, cos, sin, u4 = _inputs(mp, 8, 4)
    f = jps.make_fused_state_fn(jmp, interpret=True)

    def fwd_bwd(*a):
        y, vjp = jax.vjp(f, *a[:6])
        return y, vjp((a[6], a[7]))

    want_y, want_g = jax.jit(fwd_bwd)(*[jnp.asarray(t.numpy()) for t in (
        xr, xi, mre, mim, cos, sin, gr, gi)])
    got_y = _emulate(mp, 2, xr, xi, mre, mim, cos, sin, u4)
    for a, w in zip(got_y, want_y):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-5)
    got_g = _emulate(mp, 2, *got_y, mre, mim, cos, sin, u4, gr, gi)
    for a, w in zip(got_g, want_g):
        w = np.asarray(w)
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w, atol=2e-4 * np.abs(w).max())
