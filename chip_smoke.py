#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (qcpinn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. device      the card, nvidia-smi's name and power limit, versions, TF32 off.
2. build       nvcc builds ops/csrc/block_chain.cu, ops/csrc/gate_loop.cu and
               ops/csrc/unrolled_sv.cu from the checkout, one process per
               source, started together.
3. kernel_shapes the other sizes ``auto`` sends to the block-chain kernels
               (n = 10, 11, 12 with 3 layers; B = 37 and B = 1), and uneven
               block splits (a 128-wide block: one sample per backward CTA,
               one matrix buffer) against the plain versions, same limits as
               below, the backward bit-equal across two runs; a split with a
               block narrower than 32 (n = 10, hb = 7) must be refused.
4. kernels     every block-chain kernel at the 12q main path's shapes
               (B = 6144 stream rows and B = 682 value rows) against its
               plain PyTorch version on the same inputs: forward <= 2e-5
               (unit-norm states), backward <= 2e-4 * max|ref| per output,
               reduction <= 1e-6 * max|ref|. Times from CUDA events (median);
               K2's bound at a third of the TF32 tensor-core peak
               (3xTF32, what it runs on), beside its FP32 SIMT bound, its
               registers and shared memory.
5. step_parity one 12-qubit train step through the kernels against the same
               step on the plain block engine: same params, same points; loss
               rtol 2e-5, every grad atol 2e-4 * max(|ref|, 1e-3).
6. train       the 12q main path: the bench train step (B = 1024, hidden 50,
               lr 5e-3, seed 42), a captured CUDA graph, with the launch
               counters set to 0 just before: 3 eager warm-ups, the capture
               and a replay, then 30 timed replays. Every loss finite, each
               block-chain kernel launched exactly twice in each step the
               counters see (the warm-ups and the captured step; replays
               launch without Python), no plain version called; then a
               torch.profiler window.
6b. graph      each step the entry points capture (12q and 8q bench, 16q
               north-star stage 1 and stage 2 through ``north_star``'s own
               stage setup and ``run_steps``) against its eager plain
               version from the same seed: 13 steps each (3 eager warm-ups,
               then 10 replays), every loss within rtol 2e-5, every parameter
               within 2e-4 * max(|ref|, 1e-3); then eager, graph, graph, eager
               in one process: ms a step, launches a step, device time and
               idle share of the unprofiled step.
7. loop_shapes the gate-loop kernels (K5/K6) against their plain versions at
               every cluster size (one CTA up to 13 qubits, 2, 4, 8 CTAs at
               14, 15, 16): cross_mesh n = 10, 12, 13, 14, 15, 16, cascade
               n = 10 and n = 16 (controlled gates; at 16 qubits every
               cross-rank step kind: a high target, a high target with a low
               control, a low target with a high control, both high, u2q
               with one and with two high bits), 12q with 3 layers, B = 37
               and B = 1: forward <= 5e-6 absolute on unit-norm states,
               backward <= 2e-4 * max|ref| per output, and the backward
               bit-equal across two runs; each row with its launch shape.
8. loop_kernels K5, K6 and their slab reduction at the 16q main path's shapes
               (B = 1536 stream rows, B = 425 value rows), same limits, with
               times beside the plain versions and the plain block engine,
               the cluster size, the grid in clusters, the shared memory per
               CTA and ptxas's register count.
9. step_parity_16q one north-star stage-2 step at 16 qubits through the loop
               kernels against the same step on the plain block engine (RBF
               head, same weights and points); limits as in 5.
10. north_star the 16q main path: ``north_star.run`` at full width (16
               qubits, B = 256, hidden 64, 8 RBF units) with --backend loop,
               stage 1 its minimum chunk (500 steps), stage 2 50 steps, then
               the rel-L2 evaluation on the 20^3 grid by streams, with the
               launch counters set to 0 just before: every loss finite, K5
               and K6 launched exactly twice per stage-2 step the counters
               see (the warm-ups and the captured step; K5 twice more per
               evaluation chunk), no plain version called; ``auto`` picks
               the loop engine at 16 qubits. Then the graphed stage-2 step
               rate on the loop and block engines, interleaved (loop, block,
               loop, block: the step time spreads across processes), and a
               torch.profiler window of each.
11. unrolled_shapes the unrolled kernels (K3/K4 and the slab reduction
               K4b) against their plain versions, with the encoding (from
               |0...0>) and evolve-only: cross_mesh n = 7, 8, 9, 10, 12,
               cascade n = 8 seed 11 (controlled gates, Haar u2q), layered
               n = 8 with 3 layers, an amplitude-encoded evolve at n = 8,
               B = 37 and B = 1: forward <= 3e-5 absolute on unit-norm states
               (tests/test_pallas_sv.py), backward <= 2e-4 * max|ref| per
               output, bit-equal across two runs.
12. unrolled_kernels K3, K4 and K4b at the 8q main path's shapes (the
               evolve of B = 6144 stream rows, the apply of B = 682 value
               rows), same limits, with times beside the plain versions and
               the plain block engine's einsum chain.
13. step_parity_8q one 8q bench step through ``unrolled`` against the plain
               block engine; limits as in 5.
14. train_8q   the 8q main path: the bench train step at 8 qubits (``auto``
               picks FusedCircuit), a captured CUDA graph, driven as in 6
               with the launch counters set to 0 just before: every loss finite,
               K3, K4 and K4b launched exactly twice in each step the
               counters see, no plain version called; then a torch.profiler
               window.
15. north_star_plain ``north_star.run`` with --solver plain (DVSolver, one
               stage) at 10 qubits, B = 256, hidden 64, --backend unrolled,
               50 steps, then the 20^3 evaluation by streams: every loss
               finite, K3 launched twice per step the counters see and twice
               per evaluation chunk, K4 and K4b twice per step they see, no
               plain version called.

Then the kernel summary line, the nvidia-smi line, and the result line.

Two measurements beside the smoke test, each one JSON line:

    python3 chip_smoke.py --stage2-rate TREE   # the 16q stage-2 step of TREE's package
    python3 chip_smoke.py --loop-step-costs    # K5/K6 time per step kind at 16q
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

STEPS = 30
TIME_REPS = 20
FWD_TOL = 2e-5
BWD_RTOL = 2e-4
RED_RTOL = 1e-6
N_QUBITS = 12

# dense FP32 (non-tensor) rate, memory rate and dense TF32 tensor-core rate
# (half the data sheets' rate with sparsity) from NVIDIA's data sheets
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 378e12),
    "NVL": (60.0e12, 3.9e12, 417.5e12),
    "H200": (67.0e12, 4.8e12, 495e12),
    "H100": (67.0e12, 3.35e12, 495e12),  # SXM
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def peaks(name: str):
    """(FP32 FLOP/s, bytes/s, TF32 tensor-core FLOP/s) of the card."""
    for key in ("PCIe", "NVL", "H200", "H100"):
        if key in name:
            return PEAKS[key]
    raise SystemExit(f"no peak table for card {name!r}")


def time_ms(fn, reps=TIME_REPS):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound(flops, nbytes, card_peaks, flop_rate=None):
    """The least time (ms) for ``flops`` at ``flop_rate`` (default the FP32
    peak) and ``nbytes`` at the memory rate, and which of the two bounds it."""
    t_ops = flops / (flop_rate or card_peaks[0]) * 1e3
    t_bytes = nbytes / card_peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


LOOP_FWD_TOL = 5e-6
LOOP_SHAPES = (  # (n, ansatz, layers, B)
    (10, "cross_mesh", 1, 37), (12, "cross_mesh", 1, 37), (16, "cross_mesh", 1, 37),
    (10, "cascade", 1, 37), (12, "cross_mesh", 3, 37), (16, "cross_mesh", 1, 1),
    (12, "cross_mesh", 1, 1), (13, "cross_mesh", 1, 37), (14, "cross_mesh", 1, 37),
    (15, "cross_mesh", 1, 37), (16, "cascade", 1, 37), (16, "cascade", 1, 1),
)
# the 16q main path's evolves: 6 x 256 stream rows and 5 x 85 value rows
LOOP_BATCHES = (6 * 256, 5 * (256 // 3))
# the north-star twin bounded by steps: stage 1 its one 500-step chunk,
# stage 2 a 25-step warm-up chunk and one timed chunk of 25
NORTH_STAR_ARGS = ["--backend", "loop", "--stage1-minutes", "1e-9",
                   "--stage1-steps", "500", "--chunk", "25", "--total-steps", "50",
                   "--minutes", "30"]
RATE_STEPS = 10


def step_work(lk, steps, n, b):
    """(forward, backward) flops a gate table needs for B samples: per
    amplitude a mat step is 2 complex multiply-adds (8 flops each), a diag
    step 1 complex multiply (6), a u2q step 4 complex multiply-adds; a
    controlled mat touches half the amplitudes. The backward recovers the
    input and pulls the cotangent back (twice the forward) and accumulates
    the matrix (2 complex multiply-adds) or phase (8 flops) cotangents."""
    d = 1 << n
    fwd = bwd = 0
    for st in steps:
        if st.kind == lk.K_MAT:
            amps = d // 2 if st.ctrl else d
            fwd, bwd = fwd + 16 * amps, bwd + 48 * amps
        elif st.kind == lk.K_DIAG:
            fwd, bwd = fwd + 6 * d, bwd + 20 * d
        else:
            fwd, bwd = fwd + 32 * d, bwd + 64 * d
    return b * fwd, b * bwd


def loop_inputs(lk, circ, b, gen, dev):
    import torch

    eng = lk.LoopFusedCircuit(circ)
    lp, consts = eng.lp, eng.constants(dev)
    params = 0.3 * torch.randn(circ.num_params, generator=gen, device=dev)
    with torch.no_grad():
        m, c, s = lk.gather_scalar_inputs(circ, lp, params, consts)
    x = torch.randn(4, b, lp.hi, lp.lo, generator=gen, device=dev)
    nrm = torch.sqrt((x[0] ** 2 + x[1] ** 2).sum(dim=(1, 2), keepdim=True))
    states = [(x[0] / nrm).contiguous(), (x[1] / nrm).contiguous(),
              x[2].contiguous(), x[3].contiguous()]
    return lp, params, (m, consts.u4, c, s), states


def check_loop(lk, lp, banks, states, tag):
    """K5/K6 against the plain versions; returns the errors and the
    outputs."""
    import torch

    xr, xi, gr, gi = states
    y = lk.gate_loop_fwd(xr, xi, *banks, lp)
    y_ref = lk.loop_fwd_ref(xr, xi, *banks, lp)
    torch.cuda.synchronize()
    e_fwd = max((a - r).abs().max().item() for a, r in zip(y, y_ref))
    if not e_fwd <= LOOP_FWD_TOL:
        raise SystemExit(f"gate_loop_fwd {tag}: max abs err {e_fwd} > {LOOP_FWD_TOL}")
    got = lk.gate_loop_bwd(*y, gr, gi, *banks, lp)
    again = lk.gate_loop_bwd(*y, gr, gi, *banks, lp)
    want = lk.loop_bwd_ref(*y_ref, gr, gi, *banks, lp)
    torch.cuda.synchronize()
    e_abs = e_rel = 0.0
    for name, a, r in zip(("gxr", "gxi", "gm", "gcos", "gsin"), got, want):
        e = (a - r).abs().max().item()
        scale = r.abs().max().item()
        if not e <= BWD_RTOL * scale:
            raise SystemExit(f"gate_loop_bwd {tag} {name}: err {e} > {BWD_RTOL} * {scale}")
        e_abs, e_rel = max(e_abs, e), max(e_rel, e / scale if scale else 0.0)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"gate_loop_bwd {tag} is not deterministic")
    return {"fwd_abs": e_fwd, "bwd_abs": e_abs, "bwd_rel": e_rel}, y, y_ref


class NorthStarStepper:
    """One stage of ``north_star.run`` on a fresh model from ``args``' seed,
    set up by the run's own ``make_stage``: stage 1 (zeroed circuit,
    forward-mode residual) or stage 2 (streams residual through
    ``backend``). ``steps(n)`` takes n steps through the stage's
    ``run_steps``, as the run does (on the card, the captured graph), or
    with ``eager`` through ``step_fn`` (the plain version); both return the
    loss of each step."""

    def __init__(self, args, backend, dev, stage=2, eager=False, state_dict=None,
                 terms=None, optimizer=None):
        from qcpinn_tpu_torch import north_star as ns

        cfg, model, use_streams, _ = ns.build_model(args, dev)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model
        self.eager = eager
        self.stage = ns.make_stage(model, cfg, args, terms or ns.make_terms(args),
                                   f"stage{stage}", backend, use_streams, optimizer)

    @property
    def graph(self):
        """The stage's CapturedStep (None before the first graphed call)."""
        return self.stage.run_steps.captured

    def steps(self, n):
        import torch

        if self.eager:
            return torch.stack([self.stage.step()["loss"] for _ in range(n)])
        return self.stage.run(n)["loss"]

    def step(self):
        return self.steps(1)[0]


def block_chain_ops(blk, params):
    """The plain block engine's merged segment chain at ``params``, its
    matrices and phase planes built once: [(einsum, M) | (None, e^{i phi})]."""
    import torch

    from qcpinn_tpu_torch.ops.block_fused import _block_unitary

    lp = blk._layer_params(params)
    h, l = 1 << blk.hb, 1 << blk.lb
    ops = []
    for seg in blk.segments:
        if seg.kind == "blocks":
            mh = ml = None
            for layer, hi_prog, lo_prog in seg.block_parts():
                if hi_prog:
                    m = _block_unitary(blk.hb, hi_prog, lp(layer))
                    mh = m if mh is None else mh @ m
                if lo_prog:
                    m = _block_unitary(blk.lb, lo_prog, lp(layer))
                    ml = m if ml is None else ml @ m
            if mh is not None:
                ops.append(("bkl,km->bml", mh))
            if ml is not None:
                ops.append(("bkl,lm->bkm", ml))
        elif seg.kind == "diag":
            phi = seg.run.phases(lp(seg.layer)).reshape(1, h, l)
            ops.append((None, torch.polar(torch.ones_like(phi), phi)))
        else:
            raise SystemExit(f"block chain: unexpected segment {seg.kind}")
    return ops


def run_chain(ops, s):
    import torch

    for eq, m in ops:
        s = torch.einsum(eq, s, m) if eq else s * m
    return s


class _Fixed:
    """A sampler that returns preset points."""

    def __init__(self, X, y):
        self.X, self.y = X, y

    def sample(self, _gen, n):
        return self.X[:n], self.y[:n]


def ptxas_registers(report: str):
    """{kernel: registers per thread} from nvcc -Xptxas -v's report."""
    regs, fn = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            regs[fn] = int(m.group(1))
    return regs


def loop_phases(dev, gen, card_peaks, smi, registers):
    """Phases 7-10; returns the K5/K6/reduction rows of the summary line.
    ``registers``: ptxas's count per kernel of gate_loop.cu."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.ops import loop_kernel as lk
    from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.train import optim as topt
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS, TermSpec

    # -- 7. loop_shapes ------------------------------------------------------
    shape_errs = {}
    for n, ansatz, layers, b in LOOP_SHAPES:
        circ = DVCircuit(n, layers, ansatz, seed=42)
        lp, _, banks, states = loop_inputs(lk, circ, b, gen, dev)
        tag = f"{ansatz}_n{n}_layers{layers}_B{b}"
        shape_errs[tag], _, _ = check_loop(lk, lp, banks, states, tag)
        shape_errs[tag]["launch"] = lk.launch_plan(dev, lp, b)
    emit({"phase": "loop_shapes", "tol": {"fwd_abs": LOOP_FWD_TOL,
                                          "bwd": f"{BWD_RTOL}*max|ref|"},
          "results": shape_errs})
    torch.cuda.empty_cache()

    # -- 8. loop_kernels at the 16q main path's shapes -----------------------
    circ = DVCircuit(16, 1, "cross_mesh", seed=42)
    blk = BlockFusedCircuit(circ)
    d = 1 << circ.n
    per_kernel = {"gate_loop_fwd": {}, "gate_loop_bwd": {}, "gate_loop_reduce": {}}
    for b in LOOP_BATCHES:
        lp, params, banks, states = loop_inputs(lk, circ, b, gen, dev)
        errs, y, y_ref = check_loop(lk, lp, banks, states, f"16q_B{b}")
        shape = lk.launch_plan(dev, lp, b)
        xr, xi, gr, gi = states
        bank_bytes = 4 * sum(t.numel() for t in banks)
        f_ops, b_ops = step_work(lk, lk.steps(lp), lp.n, b)
        xc = torch.complex(xr, xi).reshape(b, 1 << blk.hb, 1 << blk.lb)
        with torch.no_grad():
            ops = block_chain_ops(blk, params)
            fb, fby = bound(f_ops, 4 * 4 * b * d + bank_bytes, card_peaks)
            per_kernel["gate_loop_fwd"][b] = {
                "max_abs_err": errs["fwd_abs"], "tol": LOOP_FWD_TOL,
                "ms": time_ms(lambda: lk.gate_loop_fwd(xr, xi, *banks, lp)),
                "plain_ms": time_ms(lambda: lk.loop_fwd_ref(xr, xi, *banks, lp), reps=5),
                "library_ms": time_ms(lambda: run_chain(ops, xc), reps=10),
                "library": "the block engine's complex einsum chain, matrices "
                           "and phases built once (cuBLAS, TF32 off)",
                "bound_ms": fb, "bound_by": fby, "cluster": shape["cluster"],
                "grid": shape["fwd_grid"], "smem_per_cta": shape["fwd_smem"],
                "registers": registers.get("gate_loop_fwd_kernel"),
            }
        out_bytes = 4 * (banks[0].numel() + 2 * banks[2].numel())
        gxr, gxi, partials = lk.gate_loop_bwd_partials(*y, gr, gi, *banks, lp)
        red = lk.gate_loop_reduce(partials)
        red_ref = lk.gate_loop_reduce_ref(partials)
        torch.cuda.synchronize()
        red_err = (red - red_ref).abs().max().item()
        if not red_err <= RED_RTOL * red_ref.abs().max().item():
            raise SystemExit(f"gate_loop_reduce B={b}: err {red_err}")
        bb, bby = bound(b_ops, 4 * 6 * b * d + bank_bytes + out_bytes, card_peaks)
        # the library's backward alone: its graph is built once, outside
        # the timed calls, as the kernel's forward is outside K6's time
        xg = xc.clone().requires_grad_(True)
        leaves = [m.clone().requires_grad_(True) for _, m in ops]
        y_lib = run_chain([(eq, m) for (eq, _), m in zip(ops, leaves)], xg)
        gc = torch.complex(gr, gi).reshape(xc.shape)
        per_kernel["gate_loop_bwd"][b] = {
            "max_abs_err": errs["bwd_abs"], "max_rel_err": errs["bwd_rel"],
            "tol": f"{BWD_RTOL}*max|ref|",
            "ms": time_ms(lambda: lk.gate_loop_bwd_partials(*y, gr, gi, *banks, lp)),
            "plain_ms": time_ms(
                lambda: lk.loop_bwd_ref(*y_ref, gr, gi, *banks, lp), reps=5),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                y_lib, [xg, *leaves], grad_outputs=gc, retain_graph=True), reps=10),
            "library": "autograd backward alone of that einsum chain",
            "bound_ms": bb, "bound_by": bby, "cluster": shape["cluster"],
            "grid": partials.shape[0], "smem_per_cta": shape["bwd_smem"],
            "registers": registers.get("gate_loop_bwd_kernel"),
        }
        if partials.shape[0] != shape["bwd_grid"]:
            raise SystemExit(f"gate_loop_bwd B={b}: {partials.shape[0]} slabs, "
                             f"want {shape['bwd_grid']}")
        del y_lib, xg, leaves, ops
        g, slab = partials.shape
        rb, rby = bound(g * slab, 4 * (g + 1) * slab, card_peaks)
        per_kernel["gate_loop_reduce"][b] = {
            "max_abs_err": red_err, "tol": f"{RED_RTOL}*max|ref|",
            "ms": time_ms(lambda: lk.gate_loop_reduce(partials)),
            "plain_ms": time_ms(lambda: lk.gate_loop_reduce_ref(partials), reps=5),
            "library_ms": time_ms(lambda: torch.sum(partials, dim=0)),
            "bound_ms": rb, "bound_by": rby, "shape": [g, slab],
        }
        del y, y_ref, gxr, gxi, partials, red, red_ref, xc, gc, states
        torch.cuda.empty_cache()
    emit({"phase": "loop_kernels", "n_qubits": 16, "card": smi, "results": per_kernel})

    # -- 9. step_parity_16q: loop vs the plain block engine -------------------
    args = ns.parse_args(NORTH_STAR_ARGS)
    terms = ns.make_terms(args)
    pgen = torch.Generator(device=dev).manual_seed(11)
    fixed = {k: TermSpec(_Fixed(*t.sampler.sample(pgen, t.batch)), t.weight, t.batch, t.kind)
             for k, t in terms.items()}
    captured = {}

    def capture(grads, state, params):
        captured["g"] = [g.detach().clone() for g in grads]
        return [torch.zeros_like(g) for g in grads], state

    opt = topt.GradientTransformation(lambda p: None, capture)
    losses, grads = {}, {}
    sd = None
    for backend in ("loop", "block"):
        st = NorthStarStepper(args, backend, dev, eager=True, state_dict=sd,
                              terms=fixed, optimizer=opt)
        sd = sd or {k: v.clone() for k, v in st.model.state_dict().items()}
        losses[backend] = st.step().item()
        grads[backend] = dict(zip([k for k, p in st.model.named_parameters()
                                   if p.requires_grad], captured["g"]))
        del st
        torch.cuda.empty_cache()
    if not math.isclose(losses["loop"], losses["block"], rel_tol=2e-5):
        raise SystemExit(f"16q step loss {losses}")
    worst = {}
    for k, ref in grads["block"].items():
        scale = max(ref.abs().max().item(), 1e-3)
        e = (grads["loop"][k] - ref).abs().max().item()
        if not e <= 2e-4 * scale:
            raise SystemExit(f"16q step grad {k}: {e} > 2e-4 * {scale}")
        worst[k] = e / scale
    emit({"phase": "step_parity_16q", "loss_loop": losses["loop"],
          "loss_block": losses["block"],
          "max_grad_err_over_scale": max(worst.values())})
    del grads

    # -- 10. north_star: the 16q main path ------------------------------------
    torch.cuda.synchronize()
    lk.reset_launches()
    t0 = time.perf_counter()
    result = ns.run(args, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lk.LAUNCHES)
    if not result["losses_finite"] or not all(
            math.isfinite(result[k]) for k in ("final_loss", "rel_l2_u", "rel_l2_r")):
        raise SystemExit(f"north_star: non-finite result {result}")
    s2 = result["stage2_steps"]
    # the counters see a stage's warm-up steps and its captured step, not
    # the replays (train/loop.py, CapturedStep)
    seen = min(s2, WARMUP_STEPS + 1)
    eval_chunks = -(-20**3 // min(512, 8 * args.batch))
    want = {"gate_loop_fwd": 2 * seen + 2 * eval_chunks, "gate_loop_bwd": 2 * seen,
            "gate_loop_reduce": 2 * seen}
    for k, v in want.items():
        if launches[k] != v:
            raise SystemExit(f"north_star: {k} launched {launches[k]} times, want {v}")
    for k in ("gate_loop_fwd_ref", "gate_loop_bwd_ref", "gate_loop_reduce_ref"):
        if launches[k] != 0:
            raise SystemExit(f"north_star: plain version {k} ran {launches[k]} times")
    if s2 < 20 or result["backend"] != "LoopFusedCircuit":
        raise SystemExit(f"north_star: stage 2 ran {s2} steps on {result['backend']}")
    # the default run (--backend auto) takes the loop engine at 16 qubits
    dflt = ns.parse_args([])
    _, model, _, backend = ns.build_model(dflt, dev)
    ns.set_engine(model, dflt, backend)
    if type(model.qblock).__name__ != "LoopFusedCircuit":
        raise SystemExit(f"north_star: auto picked {type(model.qblock).__name__}")
    del model
    # the graphed stage-2 step rate on each engine, same weights, one
    # process, in turns
    rates = {"loop": [], "block": []}
    profiles = {}
    for backend in ("loop", "block", "loop", "block"):
        st = NorthStarStepper(args, backend, dev)
        for _ in range(WARMUP_STEPS + 2):
            st.step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RATE_STEPS):
            loss = st.step()
        float(loss)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / RATE_STEPS
        rates[backend].append({"ms_per_step": 1e3 * dt, "points_per_sec": args.batch / dt})
        if backend not in profiles:
            profiles[backend] = bench.profile(st, 1e3 * dt, steps=3, top=8)
        del st
        torch.cuda.empty_cache()
    emit({"phase": "north_star", "result": result, "wall_s": wall,
          "stage2_ms_per_step": 1e3 * result["stage2_seconds"]
          / max(result["stage2_timed_steps"], 1),
          "stage2_points_per_sec": result["points_per_sec"],
          "launches": launches, "rates": rates, "profiles": profiles, "card": smi})

    sources = {
        "gate_loop_fwd": "qcpinn_tpu/ops/pallas_loop.py:316",
        "gate_loop_bwd": "qcpinn_tpu/ops/pallas_loop.py:367",
        "gate_loop_reduce": "qcpinn_tpu/ops/pallas_loop.py:375",
    }
    rows = []
    for k, by_b in per_kernel.items():
        r = by_b[LOOP_BATCHES[0]]
        rows.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/gate_loop.cu",
            "replaces": sources[k], "launches": launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "batch": LOOP_BATCHES[0],
            **{key: r[key] for key in ("cluster", "grid", "smem_per_cta", "registers")
               if key in r},
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    return rows


SV_FWD_TOL = 3e-5
SV_QUBITS = 8
SV_SHAPES = (  # (n, ansatz, layers, seed, encoding, B)
    (7, "cross_mesh", 1, 42, "angle", 37), (8, "cross_mesh", 1, 42, "angle", 37),
    (9, "cross_mesh", 1, 42, "angle", 37), (10, "cross_mesh", 1, 42, "angle", 37),
    (12, "cross_mesh", 1, 42, "angle", 37), (8, "cascade", 1, 11, "angle", 37),
    (8, "layered", 3, 42, "angle", 37), (8, "cross_mesh", 1, 42, "amplitude", 37),
    (8, "cross_mesh", 1, 42, "angle", 1), (12, "cross_mesh", 1, 42, "angle", 1),
)
# the 8q main path: the evolve of 6 x 1024 stream rows, the apply (with the
# encoding) of 2 x 341 value rows
SV_BATCHES = ((6 * 1024, "evolve"), (2 * (1024 // 3), "apply"))
SV_NAMES = ("unrolled_fwd", "unrolled_bwd", "unrolled_reduce")
# the plain-solver twin at 10 qubits, bounded by steps: a 25-step warm-up
# chunk and one timed chunk of 25
NORTH_STAR_PLAIN_ARGS = ["--solver", "plain", "--qubits", "10", "--backend",
                         "unrolled", "--chunk", "25", "--total-steps", "50",
                         "--minutes", "30"]


def sv_inputs(sk, circ, b, mode, gen, dev):
    """Kernel inputs for ``mode`` 'apply' (the encoding program from
    |0...0>) or 'evolve' (a random unit-norm state, or an amplitude-encoded
    one): (program, params, encoding inputs, banks, states)."""
    import torch

    from qcpinn_tpu_torch.ops import statevector as tsv

    eng = sk.FusedCircuit(circ)
    consts = eng.constants(dev)
    d = 1 << circ.n
    params = 0.3 * torch.randn(circ.num_params, generator=gen, device=dev)
    x = None
    if mode == "apply":
        mp = eng.mp
        x = (2 * torch.rand(b, circ.n, generator=gen, device=dev) - 1) * math.pi
        xr = consts.e0.expand(b, -1).contiguous()
        xi = torch.zeros_like(xr)
    else:
        mp = eng.mp_evolve
        if circ.encoding == "amplitude":
            st = tsv.encode_amplitude(
                torch.rand(b, d - 3, generator=gen, device=dev) + 0.1, circ.n)
            xr, xi = st.real.contiguous(), st.imag.contiguous()
        else:
            v = torch.randn(2, b, d, generator=gen, device=dev)
            v = v / torch.sqrt((v**2).sum(dim=(0, 2), keepdim=True))
            xr, xi = v[0].contiguous(), v[1].contiguous()
    with torch.no_grad():
        mre, mim, cos, sin = sk.gather_inputs(circ, mp, params, x, batch=b,
                                              consts=consts)
    if mp.num_phases == 0:
        cos = sin = consts.zero_phase
    g = torch.randn(2, b, d, generator=gen, device=dev)
    return (mp, params, x, (mre, mim, cos, sin, consts.u4),
            (xr, xi, g[0].contiguous(), g[1].contiguous()))


def check_sv(sk, mp, banks, states, tag):
    """K3/K4 against the plain versions; returns the errors and the
    outputs."""
    import torch

    xr, xi, gr, gi = states
    y = sk.unrolled_fwd(xr, xi, *banks, mp)
    y_ref = sk.unrolled_fwd_ref(xr, xi, *banks, mp)
    torch.cuda.synchronize()
    e_fwd = max((a - r).abs().max().item() for a, r in zip(y, y_ref))
    if not e_fwd <= SV_FWD_TOL:
        raise SystemExit(f"unrolled_fwd {tag}: max abs err {e_fwd} > {SV_FWD_TOL}")
    got = sk.unrolled_bwd(*y, gr, gi, *banks, mp)
    again = sk.unrolled_bwd(*y, gr, gi, *banks, mp)
    want = sk.unrolled_bwd_ref(*y_ref, gr, gi, *banks, mp)
    torch.cuda.synchronize()
    e_abs = e_rel = 0.0
    names = ("gxr", "gxi", "gmre", "gmim", "gcos", "gsin")
    for name, a, r in zip(names, got, want):
        e = (a - r).abs().max().item()
        scale = r.abs().max().item()
        if not e <= BWD_RTOL * scale:
            raise SystemExit(f"unrolled_bwd {tag} {name}: err {e} > {BWD_RTOL} * {scale}")
        e_abs, e_rel = max(e_abs, e), max(e_rel, e / scale if scale else 0.0)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"unrolled_bwd {tag} is not deterministic")
    return {"fwd_abs": e_fwd, "bwd_abs": e_abs, "bwd_rel": e_rel}, y, y_ref


def unrolled_phases(dev, gen, card_peaks, smi):
    """Phases 11-15; returns the K3/K4/reduction rows of the summary line."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.ops import loop_kernel as lk
    from qcpinn_tpu_torch.ops import sv_kernel as sk
    from qcpinn_tpu_torch.ops import statevector as tsv
    from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

    # -- 11. unrolled_shapes ---------------------------------------------------
    shape_errs = {}
    for n, ansatz, layers, seed, enc, b in SV_SHAPES:
        circ = DVCircuit(n, layers, ansatz, encoding=enc, seed=seed)
        for mode in ("evolve",) if enc == "amplitude" else ("apply", "evolve"):
            mp, _, _, banks, states = sv_inputs(sk, circ, b, mode, gen, dev)
            tag = f"{ansatz}_{enc}_n{n}_layers{layers}_B{b}_{mode}"
            shape_errs[tag], _, _ = check_sv(sk, mp, banks, states, tag)
    emit({"phase": "unrolled_shapes", "tol": {"fwd_abs": SV_FWD_TOL,
                                              "bwd": f"{BWD_RTOL}*max|ref|"},
          "results": shape_errs})
    torch.cuda.empty_cache()

    # -- 12. unrolled_kernels at the 8q main path's shapes ---------------------
    circ = DVCircuit(SV_QUBITS, 1, "cross_mesh", seed=42)
    blk = BlockFusedCircuit(circ)
    d = 1 << circ.n
    hl = (1 << blk.hb, 1 << blk.lb)
    per_kernel = {k: {} for k in SV_NAMES}
    for b, mode in SV_BATCHES:
        mp, params, x, banks, states = sv_inputs(sk, circ, b, mode, gen, dev)
        errs, y, y_ref = check_sv(sk, mp, banks, states, f"{SV_QUBITS}q_B{b}")
        xr, xi, gr, gi = states
        bank_bytes = 4 * sum(t.numel() for t in banks)
        f_ops, b_ops = step_work(lk, sk.steps(mp), mp.n, b)
        with torch.no_grad():
            ops = block_chain_ops(blk, params)
            if mode == "apply":  # the library prepares the encoded state too

                def lib_fwd():
                    return run_chain(ops, tsv.encode_angle_product(x, circ.n).reshape(b, *hl))
            else:
                xc = torch.complex(xr, xi).reshape(b, *hl)

                def lib_fwd():
                    return run_chain(ops, xc)

            fb, fby = bound(f_ops, 4 * 4 * b * d + bank_bytes, card_peaks)
            per_kernel["unrolled_fwd"][b] = {
                "mode": mode, "max_abs_err": errs["fwd_abs"], "tol": SV_FWD_TOL,
                "ms": time_ms(lambda: sk.unrolled_fwd(xr, xi, *banks, mp)),
                "plain_ms": time_ms(lambda: sk.unrolled_fwd_ref(xr, xi, *banks, mp),
                                    reps=5),
                "library_ms": time_ms(lib_fwd, reps=10),
                "library": "the block engine's complex einsum chain, matrices "
                           "and phases built once (cuBLAS, TF32 off)"
                           + ("; with the product-state encoding" if mode == "apply"
                              else ""),
                "bound_ms": fb, "bound_by": fby,
            }
        gxr, gxi, gmre, gmim, partials = sk.unrolled_bwd_partials(*y, gr, gi, *banks, mp)
        red = sk.unrolled_reduce(partials)
        red_ref = sk.unrolled_reduce_ref(partials)
        torch.cuda.synchronize()
        red_err = (red - red_ref).abs().max().item()
        if not red_err <= RED_RTOL * red_ref.abs().max().item():
            raise SystemExit(f"unrolled_reduce B={b}: err {red_err}")
        out_bytes = 4 * (gmre.numel() + gmim.numel() + banks[2].numel() + banks[3].numel())
        bb, bby = bound(b_ops, 4 * 6 * b * d + bank_bytes + out_bytes, card_peaks)
        # the library's backward alone, on the prepared state: its graph is
        # built once, outside the timed calls, as the kernel's forward is
        # outside K4's time
        xg = torch.complex(xr, xi).reshape(b, *hl).requires_grad_(True)
        leaves = [m.clone().requires_grad_(True) for _, m in ops]
        y_lib = run_chain([(eq, m) for (eq, _), m in zip(ops, leaves)], xg)
        gc = torch.complex(gr, gi).reshape(xg.shape)
        per_kernel["unrolled_bwd"][b] = {
            "mode": mode, "max_abs_err": errs["bwd_abs"], "max_rel_err": errs["bwd_rel"],
            "tol": f"{BWD_RTOL}*max|ref|",
            "ms": time_ms(lambda: sk.unrolled_bwd_partials(*y, gr, gi, *banks, mp)),
            "plain_ms": time_ms(
                lambda: sk.unrolled_bwd_ref(*y_ref, gr, gi, *banks, mp), reps=5),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                y_lib, [xg, *leaves], grad_outputs=gc, retain_graph=True), reps=10),
            "library": "autograd backward alone of that einsum chain (no encoding)",
            "bound_ms": bb, "bound_by": bby, "grid": partials.shape[0],
        }
        del y_lib, xg, leaves, ops
        g, slab = partials.shape
        rb, rby = bound(g * slab, 4 * (g + 1) * slab, card_peaks)
        per_kernel["unrolled_reduce"][b] = {
            "max_abs_err": red_err, "tol": f"{RED_RTOL}*max|ref|",
            "ms": time_ms(lambda: sk.unrolled_reduce(partials)),
            "plain_ms": time_ms(lambda: sk.unrolled_reduce_ref(partials), reps=5),
            "library_ms": time_ms(lambda: torch.sum(partials, dim=0)),
            "bound_ms": rb, "bound_by": rby, "shape": [g, slab],
        }
        del y, y_ref, gxr, gxi, gmre, gmim, partials, red, red_ref, gc, states
        torch.cuda.empty_cache()
    emit({"phase": "unrolled_kernels", "n_qubits": SV_QUBITS, "card": smi,
          "results": per_kernel})

    # -- 13. step_parity_8q: unrolled vs the plain block engine ----------------
    emit({"phase": "step_parity_8q", **step_parity(bench, SV_QUBITS, "unrolled")})

    # -- 14. train_8q: the 8q main path, the bench train step -----------------
    trainer = bench.build(n_qubits=SV_QUBITS)
    if not isinstance(trainer.model._fused, sk.FusedCircuit):
        raise SystemExit(f"auto picked {type(trainer.model._fused).__name__} at 8q")
    launches, row = run_train(trainer, sk, SV_NAMES)
    emit({"phase": "train_8q", **row, "card": smi,
          "profile": bench.profile(trainer, row["ms_per_step"], steps=3, top=8)})
    del trainer
    torch.cuda.empty_cache()

    # -- 15. north_star_plain: DVSolver at 10 qubits through K3/K4 ------------
    args = ns.parse_args(NORTH_STAR_PLAIN_ARGS)
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    result = ns.run(args, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ns_launches = dict(sk.LAUNCHES)
    if not result["losses_finite"] or not all(
            math.isfinite(result[k]) for k in ("final_loss", "rel_l2_u", "rel_l2_r")):
        raise SystemExit(f"north_star_plain: non-finite result {result}")
    if (result["solver"], result["backend"], result["steps"]) != (
            "plain", "FusedCircuit", args.total_steps):
        raise SystemExit(f"north_star_plain: {result}")
    eval_chunks = -(-20**3 // min(512, 8 * args.batch))
    seen = min(result["steps"], WARMUP_STEPS + 1)  # warm-ups and the capture
    want = {"unrolled_fwd": 2 * seen + 2 * eval_chunks, "unrolled_bwd": 2 * seen,
            "unrolled_reduce": 2 * seen}
    for k, v in want.items():
        if ns_launches[k] != v:
            raise SystemExit(f"north_star_plain: {k} launched {ns_launches[k]}, want {v}")
        if ns_launches[f"{k}_ref"] != 0:
            raise SystemExit(f"north_star_plain: plain version {k}_ref ran")
    emit({"phase": "north_star_plain", "result": result, "wall_s": wall,
          "launches": ns_launches, "card": smi})

    sources = {
        "unrolled_fwd": "qcpinn_tpu/ops/pallas_sv.py:284",
        "unrolled_bwd": "qcpinn_tpu/ops/pallas_sv.py:317",
        "unrolled_reduce": "qcpinn_tpu/ops/pallas_sv.py:332",
    }
    main_b = SV_BATCHES[0][0]
    rows = []
    for k, by_b in per_kernel.items():
        r = by_b[main_b]
        rows.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/unrolled_sv.cu",
            "replaces": sources[k], "launches": launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "batch": main_b,
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    return rows


def step_parity(bench, n_qubits, backend):
    """One bench train step through ``backend`` against the same step on
    the plain block engine: same params, same points; loss rtol 2e-5, every
    grad atol 2e-4 * max(|ref|, 1e-3)."""
    kern = bench.build(n_qubits=n_qubits, backend=backend)
    plain = bench.build(n_qubits=n_qubits, backend="block")
    plain.model.load_state_dict(kern.model.state_dict())
    points = kern.sample()
    grads = {}
    losses = {}
    for tag, tr in (("kernel", kern), ("plain", plain)):
        tr.model.zero_grad(set_to_none=True)
        loss = bench.bench_loss(tr.model, *points)
        loss.backward()
        losses[tag] = loss.item()
        grads[tag] = {k: p.grad.detach().clone()
                      for k, p in tr.model.named_parameters()}
    if not math.isclose(losses["kernel"], losses["plain"], rel_tol=2e-5):
        raise SystemExit(f"{n_qubits}q step loss {losses}")
    worst = {}
    for k, ref in grads["plain"].items():
        scale = max(ref.abs().max().item(), 1e-3)
        e = (grads["kernel"][k] - ref).abs().max().item()
        if not e <= 2e-4 * scale:
            raise SystemExit(f"{n_qubits}q step grad {k}: {e} > 2e-4 * {scale}")
        worst[k] = e / scale
    return {"loss_kernel": losses["kernel"], "loss_plain": losses["plain"],
            "max_grad_err_over_scale": max(worst.values())}


def run_train(trainer, lib, names):
    """The bench train steps of a fresh ``trainer``, with ``lib``'s launch
    counters set to 0 just before: WARMUP_STEPS + 2 steps (the eager
    warm-ups, the capture and a replay), then STEPS timed replays. Every
    loss finite, each kernel in ``names`` launched exactly twice in each
    step the counters see (the warm-ups and the captured step; the graph's
    replays launch it without Python), no plain version called. Returns
    (the counters, the phase's numbers)."""
    import torch

    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

    graph = trainer.graph
    lib.reset_launches()
    losses = [trainer.step() for _ in range(WARMUP_STEPS + 2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer.step() for _ in range(STEPS)]
    losses = torch.stack(losses).tolist()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(lib.LAUNCHES)
    seen = graph.eager_steps + graph.captured
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    if graph.captured != 1:
        raise SystemExit("the train steps captured no step")
    for k in names:
        if launches[k] != 2 * seen:
            raise SystemExit(f"{k}: {launches[k]} launches in {seen} steps the counters see")
        if launches[f"{k}_ref"] != 0:
            raise SystemExit(f"plain version {k}_ref ran {launches[k + '_ref']} times")
    return launches, {
        "steps": len(losses), "timed_steps": STEPS, "batch": trainer.batch,
        "counted_steps": seen, "replays": graph.replays,
        "points_per_sec": trainer.batch * STEPS / dt, "ms_per_step": 1e3 * dt / STEPS,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": launches}


GRAPH_KINDS = ("bench_12q", "bench_8q", "north_star_stage1", "north_star_stage2")
# the graph's first WARMUP_STEPS steps are eager, then 10 replays
GRAPH_PARITY_STEPS = 13
GRAPH_TIME_STEPS = 10


def take_steps(st, n):
    """``n`` steps of a bench Trainer (one ``step()`` each) or of a
    NorthStarStepper (one ``run_steps`` call of n steps, as the run takes
    a chunk); the loss of each."""
    import torch

    if isinstance(st, NorthStarStepper):
        return st.steps(n)
    return torch.stack([st.step() for _ in range(n)])


def graph_phase(dev, smi):
    """Phase ``graph``: each step the entry points capture in a CUDA graph
    against its eager plain version, from the same seed (params, optimizer
    state, sample stream): the 12q and 8q bench steps (``bench.Trainer``),
    and the 16q north-star stage-1 and stage-2 steps set up by
    ``north_star.make_stage``, GRAPH_PARITY_STEPS steps in one call of the
    stage's ``run_steps`` against as many calls of its ``step_fn``. Every
    step's loss within rtol 2e-5 and every parameter after the last step
    within 2e-4 * max(|ref|, 1e-3). Then, in one process and in the order
    eager, graph, graph, eager, the ms a step, and from a torch.profiler
    window the launches a step, the device time and the idle share."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

    args = ns.parse_args(NORTH_STAR_ARGS)

    def make(kind, eager):
        if kind == "bench_12q":
            return bench.build(eager=eager)
        if kind == "bench_8q":
            return bench.build(n_qubits=SV_QUBITS, eager=eager)
        stage = 1 if kind == "north_star_stage1" else 2
        return NorthStarStepper(args, "loop", dev, stage=stage, eager=eager)

    out = {}
    for kind in GRAPH_KINDS:
        ref, got = make(kind, True), make(kind, False)
        l_ref = take_steps(ref, GRAPH_PARITY_STEPS).tolist()
        l_got = take_steps(got, GRAPH_PARITY_STEPS).tolist()
        for i, (a, b) in enumerate(zip(l_got, l_ref)):
            if not math.isclose(a, b, rel_tol=2e-5):
                raise SystemExit(f"graph {kind} step {i}: loss {a} against eager {b}")
        worst = 0.0
        want = dict(ref.model.named_parameters())
        for k, p in got.model.named_parameters():
            scale = max(want[k].abs().max().item(), 1e-3)
            e = (p - want[k]).abs().max().item()
            if not e <= 2e-4 * scale:
                raise SystemExit(f"graph {kind} param {k}: {e} > 2e-4 * {scale}")
            worst = max(worst, e / scale)
        g = got.graph
        row = {"loss_first": l_got[0], "loss_last": l_got[-1],
               "max_loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(l_got, l_ref)),
               "max_param_err_over_scale": worst, "eager_steps": g.eager_steps,
               "captured": g.captured, "replays": g.replays, "timing": []}
        del ref, got, g
        torch.cuda.empty_cache()
        for eager in (True, False, False, True):
            st = make(kind, eager)
            take_steps(st, WARMUP_STEPS + 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(take_steps(st, GRAPH_TIME_STEPS)[-1])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / GRAPH_TIME_STEPS
            row["timing"].append({"mode": "eager" if eager else "graph",
                                  **bench.profile(st, 1e3 * dt, steps=3, top=6)})
            del st
            torch.cuda.empty_cache()
        out[kind] = row
    emit({"phase": "graph", "parity_steps": GRAPH_PARITY_STEPS,
          "tol": {"loss_rtol": 2e-5, "params": "2e-4*max(|ref|,1e-3)"},
          "results": out, "card": smi})


def stage2_rate(tree: str):
    """``--stage2-rate TREE``: the 16q north-star stage-2 step on the loop
    engine with TREE's ``qcpinn_tpu_torch`` (a tree with
    ``north_star.make_stage``, driven by this file's NorthStarStepper, the
    step graphed): 5 warm-up steps, 20 timed, a 3-step profile; one JSON
    line. To compare two trees, run it once per tree in one call, in turns
    (A, B, B, A)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(tree))
    import qcpinn_tpu_torch
    from qcpinn_tpu_torch import bench, north_star as ns

    dev = torch.device("cuda")
    args = ns.parse_args(NORTH_STAR_ARGS)
    st = NorthStarStepper(args, "loop", dev)
    st.steps(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(st.steps(20)[-1])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 20
    prof = bench.profile(st, 1e3 * dt, steps=3, top=4)
    emit({"tree": tree, "package": os.path.dirname(qcpinn_tpu_torch.__file__),
          "points_per_sec": args.batch / dt, **prof,
          "card": nvidia_smi_line()})


def loop_step_costs():
    """``--loop-step-costs``: K5 and K6 time per table step at the 16q
    main path's stream batch (B = 1536), on 32-step tables of one step kind
    each: mats on bits below 13 (one CTA's slice), mats on bits 13-15
    (across the cluster), diag (two phase planes, as the 16q table has),
    u2q within a slice, across 2 CTAs and across 4; one JSON line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from qcpinn_tpu_torch.ops import loop_kernel as lk

    n, b, steps = 16, LOOP_BATCHES[0], 32
    kinds = {  # (kind, ga, gb, ctrl, bank index) per step
        "mat_local": [(0, g % 13, 0, 0, g) for g in range(steps)],
        "mat_cross": [(0, 13 + g % 3, 0, 0, g) for g in range(steps)],
        "diag": [(1, 0, 0, 0, g % 2) for g in range(steps)],
        "u2q_local": [(2, g % 12 + 1, g % 12, 1, 0) for g in range(steps)],
        "u2q_cross2": [(2, 13 + g % 3, 12 - g % 5, 1, 0) for g in range(steps)],
        "u2q_cross4": [(2, 13 + g % 3, 13 + (g + 1) % 3, 1, 0) for g in range(steps)],
    }
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    lo_bits = lk.LO_BITS

    def axis_exp(g):
        return (1, g) if g < lo_bits else (0, g - lo_bits)

    out = {}
    for name, rows in kinds.items():
        table = [[k, *axis_exp(ga), idx, ctrl, *axis_exp(gb), 0]
                 for k, ga, gb, ctrl, idx in rows]
        lp = lk.LoopProgram(
            n=n, hi=1 << (n - lo_bits), lo=1 << lo_bits,
            table=np.asarray(table, np.int32),
            num_mats=sum(r[0] == lk.K_MAT for r in rows),
            num_phases=2 if name == "diag" else 0,
            u4_bank=np.asarray(np.random.default_rng(0).normal(size=(1, 32)), np.float32))
        m = torch.randn(max(lp.num_mats, 1), 8, generator=gen, device=dev)
        phi = torch.rand(max(lp.num_phases, 1), lp.hi, lp.lo, generator=gen, device=dev)
        banks = (m, torch.tensor(lp.u4_bank, device=dev), torch.cos(phi), torch.sin(phi))
        x = 1e-2 * torch.randn(4, b, lp.hi, lp.lo, generator=gen, device=dev)
        xr, xi, gr, gi = (x[i].contiguous() for i in range(4))
        y = lk.gate_loop_fwd(xr, xi, *banks, lp)
        fwd = time_ms(lambda: lk.gate_loop_fwd(xr, xi, *banks, lp), reps=5)
        bwd = time_ms(lambda: lk.gate_loop_bwd_partials(*y, gr, gi, *banks, lp), reps=5)
        out[name] = {"fwd_ms_per_step": fwd / steps, "bwd_ms_per_step": bwd / steps}
        del x, xr, xi, gr, gi, y
    emit({"loop_step_costs": out, "n_qubits": n, "batch": b,
          "launch": lk.launch_plan(dev, lp, b), "card": nvidia_smi_line()})


def main():
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--stage2-rate":
        return stage2_rate(sys.argv[2])
    if sys.argv[1:] == ["--loop-step-costs"]:
        return loop_step_costs()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)
    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops import cuda_build
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    tf32 = {
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    if tf32["cuda_matmul_allow_tf32"] or tf32["cudnn_allow_tf32"] or (
        tf32["float32_matmul_precision"] != "highest"
    ):
        raise SystemExit(f"TF32 is on: {tf32}")
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": tf32})
    card_peaks = peaks(name)

    # -- 2. build ----------------------------------------------------------
    built = cuda_build.build_all(["block_chain", "gate_loop", "unrolled_sv"])
    emit({"phase": "build", "sources": {
        f"qcpinn_tpu_torch/ops/csrc/{name}.cu": {
            "seconds": seconds, "library": os.path.relpath(path),
            "ptxas": [ln.strip() for ln in report.splitlines()
                      if "registers" in ln or "spill" in ln]}
        for name, (path, seconds, report) in built.items()}})

    # -- 3. the other shapes auto sends to the kernels (10 <= n <= 12) ----
    gen = torch.Generator(device=dev).manual_seed(7)
    shape_errs = {}
    for n, layers, hb, b in ((10, 1, None, 37), (11, 1, None, 37),
                             (12, 3, None, 37), (12, 1, None, 1),
                             (12, 1, 7, 37), (12, 1, 5, 37), (10, 1, 7, 37)):
        eng = bk.BlockKernelCircuit(DVCircuit(n, layers, "cross_mesh", seed=42),
                                    hi_bits=hb)
        tag = f"n{n}_hb{eng.plan.hb}_layers{layers}_B{b}"
        if min(eng.plan.hb, eng.plan.lb) < bk.MIN_BLOCK_BITS:
            # a block narrower than the backward's tensor-core tiles: the
            # wrappers refuse it before any launch
            try:
                bk.check_plan(eng.plan)
            except ValueError as e:
                shape_errs[tag] = {"refused": str(e)}
                continue
            raise SystemExit(f"{tag}: check_plan accepted a {eng.plan.hb}/"
                             f"{eng.plan.lb} split")
        p = 0.3 * torch.randn(eng.circuit.num_params, generator=gen, device=dev)
        with torch.no_grad():
            m, ph = eng.kernel_inputs(p)
        hh, ll = 1 << eng.plan.hb, 1 << eng.plan.lb
        x = torch.randn(4, b, hh, ll, generator=gen, device=dev)
        nrm = torch.sqrt((x[0]**2 + x[1]**2).sum(dim=(1, 2), keepdim=True))
        xr, xi, gr, gi = (x[0] / nrm), (x[1] / nrm), x[2], x[3]
        mct = bk.conj_transpose(eng.plan, m)
        got = bk.block_chain_fwd(xr, xi, m, ph, eng.plan)
        want = bk.block_chain_fwd_ref(xr, xi, m, ph, eng.plan)
        e_fwd = max((a - r).abs().max().item() for a, r in zip(got, want))
        bwd = bk.block_chain_bwd(*got, gr.contiguous(), gi.contiguous(), mct, ph, eng.plan)
        again = bk.block_chain_bwd(*got, gr.contiguous(), gi.contiguous(), mct, ph,
                                   eng.plan)
        want = bk.block_chain_bwd_ref(*want, gr, gi, mct, ph, eng.plan)
        e_bwd = max((a - r).abs().max().item() / r.abs().max().item()
                    for a, r in zip(bwd, want))
        if not (e_fwd <= FWD_TOL and e_bwd <= BWD_RTOL):
            raise SystemExit(f"{tag}: fwd {e_fwd} bwd {e_bwd}")
        if not all(torch.equal(a, c) for a, c in zip(bwd, again)):
            raise SystemExit(f"{tag}: block_chain_bwd is not deterministic")
        shape_errs[tag] = {"fwd_abs": e_fwd, "bwd_rel": e_bwd,
                           "bwd_tile_buffers_smem": bk.bwd_config(eng.plan)}
    emit({"phase": "kernel_shapes", "results": shape_errs})

    # -- 4. kernels vs plain versions at the main path's shapes ------------
    registers = ptxas_registers(built["block_chain"][2])
    circ = DVCircuit(N_QUBITS, 1, "cross_mesh", seed=42)
    eng = bk.BlockKernelCircuit(circ)
    plan = eng.plan
    params = 0.3 * torch.randn(circ.num_params, generator=gen, device=dev)
    with torch.no_grad():
        m, p = eng.kernel_inputs(params)
    mct = bk.conj_transpose(plan, m)
    mats, phases = bk.unpack(plan, m, p)
    h, l = 1 << plan.hb, 1 << plan.lb
    mats_bytes = 4 * m.numel()
    ph_bytes = 4 * p.numel()
    mat_flops = sum(8 * h * l * plan.mat_dim(i) for i in range(plan.n_mats))

    def lib_chain(xc, mats_c, ph_c):
        s = xc
        for st in plan.steps:
            if st.kind == "mat":
                eq = "bkl,km->bml" if st.axis == "hi" else "bhk,km->bhm"
                s = torch.einsum(eq, s, mats_c[st.idx])
            else:
                s = s * ph_c[st.idx]
        return s

    mats_c = [torch.complex(mr, mi) for mr, mi in mats]
    ph_c = [torch.complex(c, s) for c, s in phases]
    per_kernel = {"block_chain_fwd": {}, "block_chain_bwd": {},
                  "block_chain_reduce": {}}
    for b in (6 * 1024, 2 * (1024 // 3)):
        xr = torch.randn(b, h, l, generator=gen, device=dev)
        xi = torch.randn(b, h, l, generator=gen, device=dev)
        nrm = torch.sqrt((xr**2 + xi**2).sum(dim=(1, 2), keepdim=True))
        xr, xi = (xr / nrm).contiguous(), (xi / nrm).contiguous()
        gr = torch.randn(b, h, l, generator=gen, device=dev)
        gi = torch.randn(b, h, l, generator=gen, device=dev)

        # K1 forward
        yr, yi = bk.block_chain_fwd(xr, xi, m, p, plan)
        ryr, ryi = bk.block_chain_fwd_ref(xr, xi, m, p, plan)
        torch.cuda.synchronize()
        err = max((yr - ryr).abs().max().item(), (yi - ryi).abs().max().item())
        if not err <= FWD_TOL:
            raise SystemExit(f"block_chain_fwd B={b}: max abs err {err} > {FWD_TOL}")
        xc = torch.complex(xr, xi)
        state_bytes = 4 * b * h * l
        fb, fby = bound(b * (mat_flops + 6 * h * l * plan.n_diags),
                        4 * state_bytes + mats_bytes + ph_bytes, card_peaks)
        per_kernel["block_chain_fwd"][b] = {
            "max_abs_err": err, "tol": FWD_TOL,
            "ms": time_ms(lambda: bk.block_chain_fwd(xr, xi, m, p, plan)),
            "plain_ms": time_ms(
                lambda: bk.block_chain_fwd_ref(xr, xi, m, p, plan)),
            "library_ms": time_ms(lambda: lib_chain(xc, mats_c, ph_c)),
            "bound_ms": fb, "bound_by": fby,
        }

        # K2 backward (kernel alone) + the reduction
        gxr, gxi, partials = bk.block_chain_bwd_partials(
            yr, yi, gr, gi, mct, p, plan)
        red = bk.block_chain_reduce(partials)
        out = bk.block_chain_bwd_ref(ryr, ryi, gr, gi, mct, p, plan)
        red_ref = bk.block_chain_reduce_ref(partials)
        got = bk.block_chain_bwd(yr, yi, gr, gi, mct, p, plan)
        torch.cuda.synchronize()
        # gx, then each mat's and each phase plane's cotangent on its own
        got_m, got_p = bk.unpack(plan, got[2], got[3])
        out_m, out_p = bk.unpack(plan, out[2], out[3])
        pairs = [(got[0], out[0]), (got[1], out[1])]
        pairs += [(a, r) for ga, ra in zip(got_m + got_p, out_m + out_p)
                  for a, r in zip(ga, ra)]
        worst, err = 0.0, 0.0
        for a, r in pairs:
            e = (a - r).abs().max().item()
            scale = r.abs().max().item()
            if not e <= BWD_RTOL * scale:
                raise SystemExit(
                    f"block_chain_bwd B={b}: err {e} > {BWD_RTOL} * {scale}")
            err = max(err, e)
            worst = max(worst, e / scale)
        red_err = (red - red_ref).abs().max().item()
        red_scale = red_ref.abs().max().item()
        if not red_err <= RED_RTOL * red_scale:
            raise SystemExit(f"block_chain_reduce: err {red_err} vs {red_scale}")
        if not (torch.equal(gxr, got[0]) and torch.equal(gxi, got[1])
                and torch.equal(red, torch.cat([got[2], got[3]]))):
            raise SystemExit("block_chain_bwd is not deterministic")
        slab = partials.shape[1]
        # three complex products a mat step: the inputs hold no forward
        # state, so each step's input is recovered (one product) before dM
        # and the pullback (two more); K2 runs them on tensor cores in
        # 3xTF32, three TF32 passes per f32 product
        bwd_flops = 3 * b * mat_flops + 20 * b * h * l * plan.n_diags
        bwd_bytes = 6 * state_bytes + mats_bytes + ph_bytes + 4 * slab
        bb, bby = bound(bwd_flops, bwd_bytes, card_peaks, flop_rate=card_peaks[2] / 3)
        tile, bufs, bwd_smem = bk.bwd_config(plan)
        xg = xc.clone().requires_grad_(True)
        mg = [m.clone().requires_grad_(True) for m in mats_c]
        pg = [p.clone().requires_grad_(True) for p in ph_c]
        gc = torch.complex(gr, gi)
        # the library's backward alone: its graph is built once, outside
        # the timed calls, as the kernel's forward is outside K2's time
        y_lib = lib_chain(xg, mg, pg)

        def lib_bwd():
            return torch.autograd.grad(y_lib, [xg, *mg, *pg], grad_outputs=gc,
                                       retain_graph=True)

        per_kernel["block_chain_bwd"][b] = {
            "max_abs_err": err, "max_rel_err": worst, "tol": f"{BWD_RTOL}*max|ref|",
            "ms": time_ms(lambda: bk.block_chain_bwd_partials(
                yr, yi, gr, gi, mct, p, plan)),
            "plain_ms": time_ms(lambda: bk.block_chain_bwd_ref(
                ryr, ryi, gr, gi, mct, p, plan)),
            "library_ms": time_ms(lib_bwd),
            "library": "autograd backward alone of the complex einsum chain",
            "bound_ms": bb, "bound_by": bby,
            "bound_rate": "a third of the TF32 tensor-core peak (3xTF32)",
            # the same work on the FP32 SIMT units, as the kernel before
            # the tensor cores ran it
            "bound_fp32_ms": bound(bwd_flops, bwd_bytes, card_peaks)[0],
            "grid": partials.shape[0], "samples_per_tile": tile,
            "mct_buffers": bufs, "smem_per_cta": bwd_smem,
            "registers": registers.get("block_chain_bwd_kernel"),
        }
        g = partials.shape[0]
        rb, rby = bound(g * slab, 4 * (g + 1) * slab, card_peaks)
        per_kernel["block_chain_reduce"][b] = {
            "max_abs_err": red_err, "tol": f"{RED_RTOL}*max|ref|",
            "ms": time_ms(lambda: bk.block_chain_reduce(partials)),
            "plain_ms": time_ms(lambda: bk.block_chain_reduce_ref(partials)),
            "library_ms": time_ms(lambda: torch.sum(partials, dim=0)),
            "bound_ms": rb, "bound_by": rby, "shape": [g, slab],
        }
    emit({"phase": "kernels", "n_qubits": N_QUBITS, "card": smi,
          "results": per_kernel})

    # -- 5. one train step: kernels vs the plain block engine --------------
    emit({"phase": "step_parity", **step_parity(bench, N_QUBITS, "block_kernel")})

    # -- 6. the main path: the bench train step ----------------------------
    trainer = bench.build()
    if not isinstance(trainer.model._fused, bk.BlockKernelCircuit):
        raise SystemExit(f"auto picked {type(trainer.model._fused).__name__}")
    launches, row = run_train(trainer, bk, ("block_chain_fwd", "block_chain_bwd",
                                            "block_chain_reduce"))
    emit({"phase": "train", **row, "card": smi,
          "profile": bench.profile(trainer, row["ms_per_step"], steps=3, top=8)})

    del trainer
    torch.cuda.empty_cache()

    # -- 6b. graph: every captured step against its eager version ----------
    graph_phase(dev, smi)
    torch.cuda.empty_cache()

    # -- 7-10. the 16q north-star path through the gate-loop kernels ---------
    loop_results = loop_phases(dev, gen, card_peaks, smi,
                               ptxas_registers(built["gate_loop"][2]))
    torch.cuda.empty_cache()

    # -- 11-15. the 8q main path and the plain solver through K3/K4 ----------
    unrolled_results = unrolled_phases(dev, gen, card_peaks, smi)

    sources = {
        "block_chain_fwd": "qcpinn_tpu/ops/block_pallas.py:189",
        "block_chain_bwd": "qcpinn_tpu/ops/block_pallas.py:222",
        "block_chain_reduce": "qcpinn_tpu/ops/block_pallas.py:241",
    }
    main_b = 6 * 1024
    kernels = []
    for k, by_b in per_kernel.items():
        r = by_b[main_b]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/block_chain.cu",
            "replaces": sources[k], "launches": launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "batch": main_b,
            **{key: r[key] for key in ("bound_rate", "bound_fp32_ms", "smem_per_cta",
                                       "registers")
               if key in r},
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    kernels += loop_results + unrolled_results
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
