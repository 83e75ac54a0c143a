#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (qcpinn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. device      the card, nvidia-smi's name and power limit, versions, TF32 off.
2. build       nvcc builds ops/csrc/block_chain.cu, block_chain_cluster.cu,
               gate_loop.cu and unrolled_sv.cu from the checkout, one
               process per source, started together.
3. kernel_shapes every configuration of the block-chain kernels against
               the plain versions, same limits as below, each kernel
               bit-equal across two runs, each row with the pair that ran it
               and its launch shape: the 12q pair at the other sizes
               ``auto`` sends to it (n = 10, 11, 12 with 3 layers; B = 37,
               B = 1 and B = 682, where K1 takes tiles of 3 samples) and its
               uneven splits (a 128-wide block: one matrix buffer, one
               sample per backward CTA), and a hand-made 12q plan whose
               diag steps K1 cannot fold into a product (HAND_PLAN); the
               cluster pair at n = 2, 3, 4, 8, 9 (blocks 2-16 wide), n = 4
               at hb 1 and 3, n = 10 at hb 7, n = 12 at hb 2 and 8, and 13,
               14, 15, 16 qubits (clusters of 1-8 CTAs), B = 37.
3a. slab_sums  the three slab reductions (K2b, K6b, K4b), one header
               (ops/csrc/slab_sum.cuh), at edge shapes of both its forms
               (SLAB_SHAPES), each bit-equal to its plain version.
3b. launch_floor an empty kernel (LAUNCH_FLOOR_CU, built here) in the graph
               timer: the least a graphed kernel node costs on this card.
3c. k4b_probe  K3, K4 and K4b (and torch.sum over K4b's slabs) at the 8q
               stream batch, timed here, before the 16q phases, and again
               after them (the same function, ``when`` says which).
4. kernels     every block-chain kernel at the 12q main path's shapes
               (B = 6144 stream rows and B = 682 value rows, inputs from a
               seed of their own: ``block_main_inputs``) against its plain
               PyTorch version on the same inputs: forward <= 2e-5
               (unit-norm states) and bit-equal across two runs, backward
               <= 2e-4 * max|ref| per output, reduction bit-equal (both add
               slab 0, 1, ..., G-1 in order). Times from CUDA events
               (median of single calls, the wrapper's host side included:
               ``ms``) and, for every row under 1 ms and every reduction,
               from a CUDA graph of 20 calls (``graph_ms``: the card's
               time), the library's autograd backward too
               (``autograd_timed``); K1's and K2's bounds at a third of the
               TF32 tensor-core peak (3xTF32, what they run on), beside the
               FP32 SIMT bound, their tiles, grid, registers and shared
               memory, and K1 at every tile of samples that fits
               (``k1_tile_sweep``: each within the limit, timed).
5. step_parity one 12-qubit train step through the kernels against the same
               step on the plain block engine, at each of STEP_SEEDS: same
               params, same points; loss rtol 2e-5, every grad atol 2e-4 *
               max(|ref|, 1e-3).
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
6c. stage1_jet the 16q stage-1 step on its forward jet (physics/jet.py),
               graphed, against the same step on the jet's plain version
               (the nested jvps of diffusion_operator_fwd), eager, from the
               same seed: 13 steps, limits as in 6b; then both graphed in
               turns (nested, jet, jet, nested): ms, launches and device
               time a step.
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
               K4b; K4 on its warp route at n <= 9, its CTA route above)
               against their plain versions, with the encoding (from
               |0...0>) and evolve-only: cross_mesh n = 1, 2, 4, 7, 8, 9,
               10, 12, cascade n = 3 (2 layers), 8 and 9 (controlled gates,
               Haar u2q), alternate n = 5 and 6 (u2q on lane bits, 4-5
               phase rows), layered n = 8 with 3 layers, an
               amplitude-encoded evolve at n = 8, B = 37 and B = 1: forward
               <= 3e-5 absolute on unit-norm states (tests/test_pallas_sv.py),
               backward <= 2e-4 * max|ref| per output, bit-equal across two
               runs.
12. unrolled_kernels K3, K4 (warp route) and K4b at the 8q main path's
               shapes (the evolve of B = 6144 stream rows, the apply of B =
               682 value rows), with K4's CTA route on the same inputs
               beside it, and the CTA route at the 10q north_star_plain
               shapes (B = 1536 and 425); same limits, with times beside the
               plain versions and the plain block engine's einsum chain,
               and the warp route's warps, shared memory and CTAs an SM.
13. step_parity_8q one 8q bench step through ``unrolled`` against the plain
               block engine; limits as in 5.
14. train_8q   the 8q main path: the bench train step at 8 qubits (``auto``
               picks FusedCircuit), a captured CUDA graph, driven as in 6
               with the launch counters set to 0 just before: every loss finite,
               K3, K4's warp route and K4b launched exactly twice in each
               step the counters see, K4's CTA route and no plain version
               called; then a torch.profiler window.
15. north_star_plain ``north_star.run`` with --solver plain (DVSolver, one
               stage) at 10 qubits, B = 256, hidden 64, --backend unrolled,
               50 steps, then the 20^3 evaluation by streams: every loss
               finite, K3 launched twice per step the counters see and twice
               per evaluation chunk, K4 (its CTA route) and K4b twice per
               step they see, K4's warp route and no plain version called.

16. cluster_kernels the cluster pair (K1/K2 at 13-16 qubits) and K2b at 16
               qubits with B = 1536 stream rows and B = 425 value rows, and
               at 13 qubits with the same batches: against the plain
               versions (limits as in 4), timed beside the plain versions,
               the complex einsum chain and its autograd backward alone,
               with the bound at a third of the TF32 tensor-core peak (the
               products run in 3xTF32) beside the FP32 SIMT figure, the
               cluster size, grid, shared memory and registers.
17. north_star_block the 16q north-star stage 2 on ``--backend
               block_kernel``: one step against the plain block engine
               (limits as in 5); 13 steps of the stage's ``run_steps`` (3
               eager warm-ups, the capture, replays) against its eager
               ``step_fn``, bit-equal (losses and parameters), with the launch counters set to
               0 just before: each cluster kernel and K2b launched twice in
               each step the counters see, no plain version called; then the
               graphed stage-2 ms a step on block_kernel and loop in one
               process, in turns (block_kernel, loop, loop, block_kernel),
               and a torch.profiler window of each.

Every reduction row (phases 4, 8, 12, 16) has ``graph_ms``, torch.sum's
``library_graph_ms``, its bound and the launch floor. Then the run's
seconds, the kernel summary line, the nvidia-smi line, and the result line.

Five measurements beside the smoke test:

    python3 chip_smoke.py --stage2-rate TREE   # the 16q stage-2 step of TREE's package
    python3 chip_smoke.py --loop-step-costs    # K5/K6 time per step kind at 16q
    python3 chip_smoke.py --unrolled-step-costs  # K4's routes per step kind at 8q
    python3 chip_smoke.py --cluster-kernels    # build, kernel_shapes, cluster_kernels
    python3 chip_smoke.py --rates TREE         # TREE's rows of phase 4 and step_parity
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
GRAPH_REPLAYS = 7
GRAPH_BELOW_MS = 1.0  # rows timed by events under this are graph-timed too
GRAPH_KEYS = ("graph_ms", "library_graph_ms", "launch_floor_ms")
FWD_TOL = 2e-5
BWD_RTOL = 2e-4
TC_RATE = "a third of the TF32 tensor-core peak (3xTF32)"
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


def graph_ms(fn, reps=TIME_REPS, stream=None):
    """The card's ms for one call of ``fn``: 3 warm-up calls, then ``reps``
    calls captured in one CUDA graph, the graph replayed GRAPH_REPLAYS
    times, each replay between two CUDA events; the median replay over
    ``reps``. No host work lies between the events (``time_ms`` times the
    wrapper's host side too), so a launch costs only its graph node: the
    launch_floor phase says how much that is. ``stream``: the stream to
    warm up and capture on (default a new one)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(GRAPH_REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(ts)


def timed(fn, reps=TIME_REPS, prefix="", stream=None, graph=None):
    """``{prefix}ms`` from CUDA events (``time_ms``) and, where ``graph``
    says so (by default where that is under GRAPH_BELOW_MS),
    ``{prefix}graph_ms`` (``graph_ms`` on ``stream``)."""
    row = {f"{prefix}ms": time_ms(fn, reps)}
    if row[f"{prefix}ms"] < GRAPH_BELOW_MS if graph is None else graph:
        row[f"{prefix}graph_ms"] = graph_ms(fn, stream=stream)
    return row


def autograd_timed(forward, grad_out, graph, reps=TIME_REPS, prefix="library_"):
    """``timed`` for the autograd backward alone of ``forward() -> (y,
    leaves)``, ``torch.autograd.grad(y, leaves, grad_out)``, graph-timed
    where ``graph`` (the kernel's row beside it is): the forward is built
    once, outside the timed calls, on a stream of its own, and every call
    runs on that stream. Autograd runs each backward op on its forward op's
    stream, so the graph timer captures the backward there (from a forward
    on another stream it would run outside the capture)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y, leaves = forward()

        def backward():
            return torch.autograd.grad(y, leaves, grad_outputs=grad_out,
                                       retain_graph=True)

        row = timed(backward, reps, prefix, stream=side, graph=graph)
    torch.cuda.current_stream().wait_stream(side)
    return row


def reduce_row(wrapper, ref, partials, card_peaks, floor):
    """A slab reduction against its plain version on ``partials`` [G,
    slab]: bit-equal (both add slab 0, 1, ..., G-1 in order), timed by
    events and by graph beside ``torch.sum(partials, 0)``, with the bound
    (G + 1 slabs moved) and the launch floor."""
    import torch

    got, want = wrapper(partials), ref(partials)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"{wrapper.__name__} {list(partials.shape)}: not bit-equal to "
                         f"its plain version (max abs err {(got - want).abs().max().item()})")
    g, slab = partials.shape
    rb, rby = bound(g * slab, 4 * (g + 1) * slab, card_peaks)
    return {
        "max_abs_err": 0.0, "tol": "bit-equal", "shape": [g, slab],
        "ms": time_ms(lambda: wrapper(partials)),
        "graph_ms": graph_ms(lambda: wrapper(partials)),
        "plain_ms": time_ms(lambda: ref(partials), reps=5),
        "library_ms": time_ms(lambda: torch.sum(partials, dim=0)),
        "library_graph_ms": graph_ms(lambda: torch.sum(partials, dim=0)),
        "bound_ms": rb, "bound_by": rby, "launch_floor_ms": floor,
    }


# (G, slab, offset): one slab; slabs of 1 to 4099 floats (the lanes form:
# tiles of 1 to 16 columns) with G under, at and past one round of rows and
# not a multiple of the 8 rows the adder reads ahead; a slab just past the
# per-element form's threshold, its last CTA ragged; partials one float
# into their allocation
SLAB_SHAPES = ((1, 4096, 0), (2, 3, 0), (15, 4099, 0), (17, 100, 0), (33, 1, 0),
               (132, 4096, 0), (300, 777, 0), (3, 40001, 0), (5, 4096, 1))


def slab_sum_phase(dev, gen):
    """Phase ``slab_sums``: the three slab reductions (K2b, K6b, K4b) at
    SLAB_SHAPES, each bit-equal to its plain version."""
    import torch

    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops import loop_kernel as lk
    from qcpinn_tpu_torch.ops import sv_kernel as sk

    pairs = ((bk.block_chain_reduce, bk.block_chain_reduce_ref),
             (lk.gate_loop_reduce, lk.gate_loop_reduce_ref),
             (sk.unrolled_reduce, sk.unrolled_reduce_ref))
    rows = []
    for g, slab, off in SLAB_SHAPES:
        flat = torch.randn(off + g * slab, generator=gen, device=dev)
        partials = flat[off:].view(g, slab)
        for wrapper, ref in pairs:
            got, want = wrapper(partials), ref(partials)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"slab_sums {wrapper.__name__} G={g} slab={slab} "
                                 f"offset={off}: not bit-equal to its plain version")
        rows.append([g, slab, off])
    emit({"phase": "slab_sums", "tol": "bit-equal", "shapes_g_slab_offset": rows,
          "kernels": [w.__name__ for w, _ in pairs]})


# an empty kernel and its launcher, built by launch_floor_phase alone: no
# path of the port runs it
LAUNCH_FLOOR_CU = r"""
extern "C" __global__ void launch_floor_kernel() {}
extern "C" int qc_launch_floor(void* stream) {
    launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""


def launch_floor_phase():
    """Phase ``launch_floor``: an empty kernel (one CTA of 32 threads,
    LAUNCH_FLOOR_CU built with the port's nvcc flags into the git-ignored
    build directory) in the graph timer, the least a graphed kernel node
    costs on this card, and in the event timer beside it."""
    import ctypes

    import torch

    from qcpinn_tpu_torch.ops import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "launch_floor.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR, "launch_floor.so")
    with open(src, "w") as f:
        f.write(LAUNCH_FLOOR_CU)
    done = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib_path, src],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"launch_floor: nvcc failed:\n{done.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.qc_launch_floor.argtypes = [ctypes.c_void_p]
    lib.qc_launch_floor.restype = ctypes.c_int

    def empty():
        err = lib.qc_launch_floor(torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch_floor: CUDA error {err}")

    row = {"phase": "launch_floor", "graph_ms": graph_ms(empty), "ms": time_ms(empty)}
    emit(row)
    return row["graph_ms"]


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
    set up by the run's own ``make_stage``: stage 1 (zeroed circuit, the
    forward jet's residual, or with ``plain_residual`` its plain version,
    the nested jvps of ``diffusion_operator_fwd``) or stage 2 (streams
    residual through ``backend``). ``steps(n)`` takes n steps through the stage's ``run_steps``, as the run
    does (on the card, the captured graph), or with ``eager`` through
    ``step_fn`` (the plain version); both return the loss of each step."""

    def __init__(self, args, backend, dev, stage=2, eager=False, state_dict=None,
                 terms=None, optimizer=None, plain_residual=False):
        from qcpinn_tpu_torch import north_star as ns

        cfg, model, use_streams, _ = ns.build_model(args, dev)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model
        self.eager = eager
        # --stage2-rate may load a tree whose make_stage takes no residual_fn
        kw = {"residual_fn": lambda X: ns.diffusion_operator_fwd(model, X)} \
            if plain_residual else {}
        self.stage = ns.make_stage(model, cfg, args, terms or ns.make_terms(args),
                                   f"stage{stage}", backend, use_streams, optimizer,
                                   **kw)

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


def chain_forward(ops, x):
    """``autograd_timed``'s forward of ``run_chain(ops, x)``: fresh leaves
    for the state and every matrix and phase plane."""

    def forward():
        xg = x.clone().requires_grad_(True)
        leaves = [m.clone().requires_grad_(True) for _, m in ops]
        return run_chain([(eq, m) for (eq, _), m in zip(ops, leaves)], xg), [xg, *leaves]

    return forward


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


def loop_phases(dev, gen, card_peaks, smi, registers, floor):
    """Phases 7-10; returns the K5/K6/reduction rows of the summary line.
    ``registers``: ptxas's count per kernel of gate_loop.cu; ``floor``: the
    launch floor (ms)."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.ops import loop_kernel as lk
    from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

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
                **timed(lambda: lk.gate_loop_fwd(xr, xi, *banks, lp)),
                "plain_ms": time_ms(lambda: lk.loop_fwd_ref(xr, xi, *banks, lp), reps=5),
                **timed(lambda: run_chain(ops, xc), reps=10, prefix="library_"),
                "library": "the block engine's complex einsum chain, matrices "
                           "and phases built once (cuBLAS, TF32 off)",
                "bound_ms": fb, "bound_by": fby, "cluster": shape["cluster"],
                "grid": shape["fwd_grid"], "smem_per_cta": shape["fwd_smem"],
                "registers": registers.get("gate_loop_fwd_kernel"),
            }
        out_bytes = 4 * (banks[0].numel() + 2 * banks[2].numel())
        gxr, gxi, partials = lk.gate_loop_bwd_partials(*y, gr, gi, *banks, lp)
        bb, bby = bound(b_ops, 4 * 6 * b * d + bank_bytes + out_bytes, card_peaks)
        # the library's backward alone: its graph is built once, outside
        # the timed calls, as the kernel's forward is outside K6's time
        gc = torch.complex(gr, gi).reshape(xc.shape)
        kern = timed(lambda: lk.gate_loop_bwd_partials(*y, gr, gi, *banks, lp))
        per_kernel["gate_loop_bwd"][b] = {
            "max_abs_err": errs["bwd_abs"], "max_rel_err": errs["bwd_rel"],
            "tol": f"{BWD_RTOL}*max|ref|", **kern,
            "plain_ms": time_ms(
                lambda: lk.loop_bwd_ref(*y_ref, gr, gi, *banks, lp), reps=5),
            **autograd_timed(chain_forward(ops, xc), gc, "graph_ms" in kern, reps=10),
            "library": "autograd backward alone of that einsum chain",
            "bound_ms": bb, "bound_by": bby, "cluster": shape["cluster"],
            "grid": partials.shape[0], "smem_per_cta": shape["bwd_smem"],
            "registers": registers.get("gate_loop_bwd_kernel"),
        }
        if partials.shape[0] != shape["bwd_grid"]:
            raise SystemExit(f"gate_loop_bwd B={b}: {partials.shape[0]} slabs, "
                             f"want {shape['bwd_grid']}")
        del ops
        per_kernel["gate_loop_reduce"][b] = reduce_row(
            lk.gate_loop_reduce, lk.gate_loop_reduce_ref, partials, card_peaks, floor)
        del y, y_ref, gxr, gxi, partials, xc, gc, states
        torch.cuda.empty_cache()
    emit({"phase": "loop_kernels", "n_qubits": 16, "card": smi, "results": per_kernel})

    # -- 9. step_parity_16q: loop vs the plain block engine -------------------
    args = ns.parse_args(NORTH_STAR_ARGS)
    emit({"phase": "step_parity_16q", **stage2_parity(args, dev, "loop")})

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
            **{key: r[key] for key in GRAPH_KEYS if key in r},
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
    # K4's warp route below a warp's 32 lanes (idle lanes) and at 5-6 qubits
    # (u2q on lane bits, then on one lane and one register bit; 4-5 phase
    # rows, past the ones the lanes keep in registers), and 9q controlled
    (1, "cross_mesh", 1, 42, "angle", 37), (2, "cross_mesh", 1, 42, "angle", 37),
    (3, "cascade", 2, 42, "angle", 37), (4, "cross_mesh", 1, 42, "angle", 37),
    (4, "cross_mesh", 1, 42, "angle", 1), (5, "alternate", 1, 42, "angle", 37),
    (6, "alternate", 1, 42, "angle", 37), (9, "cascade", 1, 11, "angle", 37),
)
# the 8q main path: the evolve of 6 x 1024 stream rows, the apply (with the
# encoding) of 2 x 341 value rows
SV_BATCHES = ((6 * 1024, "evolve"), (2 * (1024 // 3), "apply"))
SV_NAMES = ("unrolled_fwd", "unrolled_bwd_warp", "unrolled_reduce")
# K4's CTA route (10 <= n <= 12) on its main path, north_star_plain at 10
# qubits: the evolve of 6 x 256 stream rows, the apply of 5 x 85 value rows
SV_CTA_QUBITS = 10
SV_CTA_BATCHES = ((6 * 256, "evolve"), (5 * (256 // 3), "apply"))
# the plain version a kernel's launch counter is held against, where it is
# not the kernel's name with _ref (both K4 routes share one)
PLAIN_NAME = {"unrolled_bwd_warp": "unrolled_bwd_ref"}
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


def unrolled_phases(dev, gen, card_peaks, smi, registers, floor):
    """Phases 11-15; returns the K3/K4/reduction rows of the summary line.
    ``registers``: ptxas's count per kernel of unrolled_sv.cu; ``floor``:
    the launch floor (ms)."""
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

    # -- 12. unrolled_kernels at the 8q main path's shapes, and K4's CTA ------
    # route at the 10q main path's (north_star_plain)
    per_kernel = {k: {} for k in (*SV_NAMES, "unrolled_bwd")}
    for n_q, batches in ((SV_QUBITS, SV_BATCHES), (SV_CTA_QUBITS, SV_CTA_BATCHES)):
        circ = DVCircuit(n_q, 1, "cross_mesh", seed=42)
        blk = BlockFusedCircuit(circ)
        d = 1 << circ.n
        hl = (1 << blk.hb, 1 << blk.lb)
        warp_route = n_q <= sk.WARP_MAX_QUBITS
        for b, mode in batches:
            mp, params, x, banks, states = sv_inputs(sk, circ, b, mode, gen, dev)
            errs, y, y_ref = check_sv(sk, mp, banks, states, f"{n_q}q_B{b}")
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

                if warp_route:
                    fb, fby = bound(f_ops, 4 * 4 * b * d + bank_bytes, card_peaks)
                    per_kernel["unrolled_fwd"][b] = {
                        "mode": mode, "max_abs_err": errs["fwd_abs"], "tol": SV_FWD_TOL,
                        **timed(lambda: sk.unrolled_fwd(xr, xi, *banks, mp)),
                        "plain_ms": time_ms(
                            lambda: sk.unrolled_fwd_ref(xr, xi, *banks, mp), reps=5),
                        **timed(lib_fwd, reps=10, prefix="library_"),
                        "library": "the block engine's complex einsum chain, matrices "
                                   "and phases built once (cuBLAS, TF32 off)"
                                   + ("; with the product-state encoding"
                                      if mode == "apply" else ""),
                        "bound_ms": fb, "bound_by": fby,
                    }
            route = (sk.unrolled_bwd_warp_partials if warp_route
                     else sk.unrolled_bwd_cta_partials)
            gxr, gxi, gmre, gmim, partials = route(*y, gr, gi, *banks, mp)
            out_bytes = 4 * (gmre.numel() + gmim.numel() + banks[2].numel()
                             + banks[3].numel())
            bb, bby = bound(b_ops, 4 * 6 * b * d + bank_bytes + out_bytes, card_peaks)
            # the library's backward alone, on the prepared state: its graph
            # is built once, outside the timed calls, as the kernel's forward
            # is outside K4's time
            gc = torch.complex(gr, gi).reshape(b, *hl)
            kern = timed(lambda: route(*y, gr, gi, *banks, mp))
            row = {
                "n_qubits": n_q, "mode": mode, "max_abs_err": errs["bwd_abs"],
                "max_rel_err": errs["bwd_rel"], "tol": f"{BWD_RTOL}*max|ref|", **kern,
                "plain_ms": time_ms(
                    lambda: sk.unrolled_bwd_ref(*y_ref, gr, gi, *banks, mp), reps=5),
                **autograd_timed(chain_forward(ops, torch.complex(xr, xi).reshape(b, *hl)),
                                 gc, "graph_ms" in kern, reps=10),
                "library": "autograd backward alone of that einsum chain (no encoding)",
                "bound_ms": bb, "bound_by": bby, "grid": partials.shape[0],
            }
            if warp_route:
                warps, smem, _, blocks = sk.warp_config(
                    dev, mp.n, banks[0].shape[1], banks[2].shape[0], banks[4].shape[0], b)
                row.update({
                    "warps_per_cta": warps, "smem_per_cta": smem, "ctas_per_sm": blocks,
                    "registers": registers.get(f"unrolled_bwd_warp_kernel_rb{mp.n - 5}"),
                    # the CTA route on the same inputs, the kernel this route
                    # replaced at n <= 9
                    **timed(lambda: sk.unrolled_bwd_cta_partials(*y, gr, gi, *banks, mp),
                            prefix="cta_route_", graph="graph_ms" in kern),
                })
                per_kernel["unrolled_bwd_warp"][b] = row
                per_kernel["unrolled_reduce"][b] = reduce_row(
                    sk.unrolled_reduce, sk.unrolled_reduce_ref, partials, card_peaks, floor)
            else:
                row["registers"] = registers.get("unrolled_bwd_kernel")
                per_kernel["unrolled_bwd"][b] = row
            del ops, y, y_ref, gxr, gxi, gmre, gmim, partials, gc, states
            torch.cuda.empty_cache()
    emit({"phase": "unrolled_kernels", "n_qubits": SV_QUBITS, "cta_route_qubits": SV_CTA_QUBITS,
          "card": smi, "results": per_kernel})

    # -- 13. step_parity_8q: unrolled vs the plain block engine ----------------
    emit({"phase": "step_parity_8q", **step_parity(bench, SV_QUBITS, "unrolled")})

    # -- 14. train_8q: the 8q main path, the bench train step -----------------
    trainer = bench.build(n_qubits=SV_QUBITS)
    if not isinstance(trainer.model._fused, sk.FusedCircuit):
        raise SystemExit(f"auto picked {type(trainer.model._fused).__name__} at 8q")
    launches, row = run_train(trainer, sk, SV_NAMES)
    if launches["unrolled_bwd"] != 0:
        raise SystemExit(f"train_8q: K4's CTA route ran {launches['unrolled_bwd']} times")
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
            "unrolled_reduce": 2 * seen, "unrolled_bwd_warp": 0}
    for k, v in want.items():
        if ns_launches[k] != v:
            raise SystemExit(f"north_star_plain: {k} launched {ns_launches[k]}, want {v}")
        if ns_launches[PLAIN_NAME.get(k, f"{k}_ref")] != 0:
            raise SystemExit(f"north_star_plain: the plain version of {k} ran")
    emit({"phase": "north_star_plain", "result": result, "wall_s": wall,
          "launches": ns_launches, "card": smi})

    sources = {
        "unrolled_fwd": "qcpinn_tpu/ops/pallas_sv.py:284",
        "unrolled_bwd_warp": "qcpinn_tpu/ops/pallas_sv.py:317",
        "unrolled_bwd": "qcpinn_tpu/ops/pallas_sv.py:317",
        "unrolled_reduce": "qcpinn_tpu/ops/pallas_sv.py:332",
    }
    rows = []
    for k, by_b in per_kernel.items():
        # K4's CTA route: its launches and shapes on north_star_plain (10q)
        cta = k == "unrolled_bwd"
        main_b = (SV_CTA_BATCHES if cta else SV_BATCHES)[0][0]
        r = by_b[main_b]
        rows.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/unrolled_sv.cu",
            "replaces": sources[k], "launches": (ns_launches if cta else launches)[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in GRAPH_KEYS if key in r},
            "batch": main_b, "n_qubits": SV_CTA_QUBITS if cta else SV_QUBITS,
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    return rows


def step_parity(bench, n_qubits, backend, seed=42):
    """One bench train step (``bench.build``'s ``seed``) through
    ``backend`` against the same step on the plain block engine: same
    params, same points; loss rtol 2e-5, every grad atol 2e-4 * max(|ref|,
    1e-3)."""
    kern = bench.build(n_qubits=n_qubits, backend=backend, seed=seed)
    plain = bench.build(n_qubits=n_qubits, backend="block", seed=seed)
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
            "loss_rel_err": abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"]),
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
        ref = PLAIN_NAME.get(k, f"{k}_ref")
        if launches[ref] != 0:
            raise SystemExit(f"plain version {ref} ran {launches[ref]} times")
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


def graph_parity(tag, ref, got, l_ref, l_got):
    """A graphed run (``got``) against its eager plain version (``ref``)
    from the same seed: every step's loss within rtol 2e-5 and every
    parameter after the last step within 2e-4 * max(|ref|, 1e-3)."""
    for i, (a, b) in enumerate(zip(l_got, l_ref)):
        if not (math.isfinite(a) and math.isclose(a, b, rel_tol=2e-5)):
            raise SystemExit(f"{tag} step {i}: loss {a} against eager {b}")
    worst = 0.0
    want = dict(ref.model.named_parameters())
    for k, p in got.model.named_parameters():
        scale = max(want[k].abs().max().item(), 1e-3)
        e = (p - want[k]).abs().max().item()
        if not e <= 2e-4 * scale:
            raise SystemExit(f"{tag} param {k}: {e} > 2e-4 * {scale}")
        worst = max(worst, e / scale)
    g = got.graph
    return {"loss_first": l_got[0], "loss_last": l_got[-1],
            "max_loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(l_got, l_ref)),
            "bit_equal": l_got == l_ref and worst == 0.0,
            "max_param_err_over_scale": worst, "eager_steps": g.eager_steps,
            "captured": g.captured, "replays": g.replays}


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
        row = {**graph_parity(f"graph {kind}", ref, got, l_ref, l_got), "timing": []}
        del ref, got
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


def stage1_jet_phase(dev, smi):
    """Phase ``stage1_jet``: the 16q north-star stage-1 step on the forward
    jet (``physics/jet.py``), graphed through the stage's ``run_steps``,
    against the same step on its plain version, the nested jvps of
    ``diffusion_operator_fwd``, eager through ``step_fn``, from the same seed:
    GRAPH_PARITY_STEPS steps, every loss within rtol 2e-5 and every
    parameter after the last step within 2e-4 * max(|ref|, 1e-3). Then both
    graphed, in turns (nested, jet, jet, nested): ms a step, launches a step
    and device time from a 3-step profile."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

    args = ns.parse_args(NORTH_STAR_ARGS)
    ref = NorthStarStepper(args, "loop", dev, stage=1, eager=True, plain_residual=True)
    got = NorthStarStepper(args, "loop", dev, stage=1)
    l_ref = take_steps(ref, GRAPH_PARITY_STEPS).tolist()
    l_got = take_steps(got, GRAPH_PARITY_STEPS).tolist()
    row = {**graph_parity("stage1_jet", ref, got, l_ref, l_got), "timing": []}
    del ref, got
    for plain in (True, False, False, True):
        st = NorthStarStepper(args, "loop", dev, stage=1, plain_residual=plain)
        take_steps(st, WARMUP_STEPS + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(take_steps(st, GRAPH_TIME_STEPS)[-1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / GRAPH_TIME_STEPS
        row["timing"].append({"residual": "nested_jvp" if plain else "jet",
                              **bench.profile(st, 1e3 * dt, steps=3, top=6)})
        del st
        torch.cuda.empty_cache()
    emit({"phase": "stage1_jet", "parity_steps": GRAPH_PARITY_STEPS,
          "tol": {"loss_rtol": 2e-5, "params": "2e-4*max(|ref|,1e-3)"}, **row,
          "card": smi})


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


def reduction_cases(dev, gen):
    """Each slab reduction at the main paths' shapes, as (tag, partials,
    wrapper, plain version): the partials [G, slab] come from the backward
    kernel on the inputs the phases make (``block_inputs``, ``loop_inputs``,
    ``sv_inputs``). K2b on the 12q pair (12q, B = 6144 / 682) and on the
    cluster pair (16q, B = 1536 / 425), K6b (16q) and K4b (8q, the evolve
    and the apply)."""
    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops import loop_kernel as lk
    from qcpinn_tpu_torch.ops import sv_kernel as sk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    for n, batches in ((N_QUBITS, BLOCK_BATCHES), (16, LOOP_BATCHES)):
        eng = bk.BlockKernelCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
        for b in batches:
            m, p, (xr, xi, gr, gi) = block_inputs(eng, b, gen, dev)
            y = bk.block_chain_fwd(xr, xi, m, p, eng.plan)
            mct = bk.conj_transpose(eng.plan, m)
            partials = bk.block_chain_bwd_partials(*y, gr, gi, mct, p, eng.plan)[2]
            yield (f"K2b_{n}q_B{b}", partials, bk.block_chain_reduce,
                   bk.block_chain_reduce_ref)
    circ = DVCircuit(16, 1, "cross_mesh", seed=42)
    for b in LOOP_BATCHES:
        lp, _, banks, (xr, xi, gr, gi) = loop_inputs(lk, circ, b, gen, dev)
        y = lk.gate_loop_fwd(xr, xi, *banks, lp)
        partials = lk.gate_loop_bwd_partials(*y, gr, gi, *banks, lp)[2]
        yield f"K6b_16q_B{b}", partials, lk.gate_loop_reduce, lk.gate_loop_reduce_ref
    circ = DVCircuit(SV_QUBITS, 1, "cross_mesh", seed=42)
    for b, mode in SV_BATCHES:
        mp, _, _, banks, (xr, xi, gr, gi) = sv_inputs(sk, circ, b, mode, gen, dev)
        y = sk.unrolled_fwd(xr, xi, *banks, mp)
        partials = sk.unrolled_bwd_partials(*y, gr, gi, *banks, mp)[-1]
        yield f"K4b_8q_B{b}", partials, sk.unrolled_reduce, sk.unrolled_reduce_ref


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


def unrolled_step_costs():
    """``--unrolled-step-costs``: K4's two routes (warp, CTA) at 8 qubits on
    29-step tables of one step kind each (the 8q program's length): mats on
    a lane bit and on a register bit of the warp route (controlled too),
    diag, u2q on two lane bits, on a lane and a register bit and on two
    register bits; then the 8q program itself and a one-step table (the
    launch, loads and stores); graph ms at the 8q main path's two batches,
    the warp route's ms a step over the one-step table; one JSON line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from qcpinn_tpu_torch.ops import sv_kernel as sk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    n, steps = SV_QUBITS, 29
    S = sk.Step
    # wire w is bit n-1-w: wires 0-4 are the warp route's lane bits at 8q
    kinds = {
        "mat_lane": [S("1q", wire=g % 5, mat=g) for g in range(steps)],
        "mat_reg": [S("1q", wire=5 + g % 3, mat=g) for g in range(steps)],
        "mat_lane_ctrl": [S("c1q", ctrl=5 + g % 3, wire=g % 5, mat=g) for g in range(steps)],
        "diag": [S("diag", phase=g % 2) for g in range(steps)],
        "u2q_lanes": [S("u2q", ctrl=g % 5, wire=(g + 1) % 5, u4=0) for g in range(steps)],
        "u2q_lane_reg": [S("u2q", ctrl=g % 5, wire=5 + g % 3, u4=0) for g in range(steps)],
        "u2q_regs": [S("u2q", ctrl=5 + g % 3, wire=5 + (g + 1) % 3, u4=0)
                     for g in range(steps)],
        "one_step": [S("diag", phase=0)],
    }
    u = np.linalg.qr(np.random.default_rng(0).normal(size=(4, 4, 2)).view(np.complex128)[..., 0])[0]
    programs = {name: sk.MicroProgram(
        n, tuple(rows), sum(st.kind in ("1q", "c1q") for st in rows),
        2 if name == "diag" else 1, (u.astype(np.complex64),)) for name, rows in kinds.items()}
    dev = torch.device("cuda")
    eng = sk.FusedCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
    programs["program_8q"] = eng.mp_evolve
    gen = torch.Generator(device=dev).manual_seed(5)
    u4 = torch.view_as_real(torch.tensor(u, dtype=torch.complex64)).reshape(1, 32).to(dev)
    out = {}
    for b, _ in SV_BATCHES:
        x = torch.randn(4, b, 1 << n, generator=gen, device=dev)
        yr, yi, gr, gi = (x[i].contiguous() for i in range(4))
        rows = {}
        for name, mp in programs.items():
            k, p = max(mp.num_mats, 1), max(mp.num_phases, 1)
            m = torch.linalg.qr(torch.randn(b, k, 2, 2, dtype=torch.complex64, device=dev))[0]
            phi = torch.rand(p, 1 << n, generator=gen, device=dev)
            banks = (m.real.contiguous(), m.imag.contiguous(), torch.cos(phi), torch.sin(phi),
                     eng.constants(dev).u4 if name == "program_8q" else u4)
            rows[name] = {
                "steps": len(mp.steps),
                "warp_graph_ms": graph_ms(
                    lambda: sk.unrolled_bwd_warp_partials(yr, yi, gr, gi, *banks, mp)),
                "cta_graph_ms": graph_ms(
                    lambda: sk.unrolled_bwd_cta_partials(yr, yi, gr, gi, *banks, mp)),
            }
        fixed = rows["one_step"]["warp_graph_ms"]
        for name, r in rows.items():
            if r["steps"] > 1:
                r["warp_ms_per_step"] = (r["warp_graph_ms"] - fixed) / (r["steps"] - 1)
        out[str(b)] = rows
        del x, yr, yi, gr, gi
    mp8 = programs["program_8q"]
    warps, smem, grid, ctas = sk.warp_config(dev, n, mp8.num_mats, mp8.num_phases,
                                             len(mp8.u4s), SV_BATCHES[0][0])
    emit({"unrolled_step_costs": out, "n_qubits": n,
          "warp_launch_at_8q_main": {"warps_per_cta": warps, "smem_per_cta": smem,
                                     "grid": grid, "ctas_per_sm": ctas},
          "card": nvidia_smi_line()})


# (n, layers, hi_bits, B): the 12q pair's sizes and uneven splits (at B =
# 682 too, where K1 takes tiles of 3 samples, the last one ragged), then the
# cluster pair's: blocks 2-16 wide, narrow and wide splits at 10-12 qubits,
# and 13-16 qubits
BLOCK_SHAPES = (
    (10, 1, None, 37), (11, 1, None, 37), (12, 3, None, 37), (12, 1, None, 1),
    (12, 1, 7, 37), (12, 1, 5, 37),
    (10, 1, None, 682), (11, 1, None, 682), (12, 3, None, 682), (12, 1, 7, 682),
    (12, 1, 5, 682),
    (2, 1, None, 37), (3, 1, None, 37), (4, 1, None, 37), (4, 1, 1, 37), (4, 1, 3, 37),
    (8, 1, None, 37), (9, 1, None, 37), (10, 1, 7, 37), (12, 1, 2, 37), (12, 1, 8, 37),
    (13, 1, None, 37), (14, 1, None, 37), (15, 1, None, 37), (16, 1, None, 37),
)
# a 12q plan no ansatz makes, for K1's diag steps that no mat step precedes:
# a diag first, a diag after a mat (folded into its product), a diag after
# a diag, a mat last
HAND_PLAN = (("diag", ""), ("mat", "lo"), ("diag", ""), ("diag", ""), ("mat", "hi"))
CLUSTER_SHAPES = ((16, LOOP_BATCHES), (13, LOOP_BATCHES))
# the 12q main path's evolves: 6 x 1024 stream rows and 2 x 341 value rows
BLOCK_BATCHES = (6 * 1024, 2 * (1024 // 3))
# the seeds of the 12q step_parity phase (bench.build's default, then one
# more)
STEP_SEEDS = (42, 7)


def unit_states(b, h, l, gen, dev):
    """Unit-norm states (re, im) and a random cotangent (re, im), [B, H, L]."""
    import torch

    x = torch.randn(4, b, h, l, generator=gen, device=dev)
    nrm = torch.sqrt((x[0]**2 + x[1]**2).sum(dim=(1, 2), keepdim=True))
    return [(x[0] / nrm).contiguous(), (x[1] / nrm).contiguous(),
            x[2].contiguous(), x[3].contiguous()]


def block_inputs(eng, b, gen, dev):
    """Packed mats and phases of ``eng`` at random params, unit-norm states
    and a random cotangent [B, H, L]."""
    import torch

    p = 0.3 * torch.randn(eng.circuit.num_params, generator=gen, device=dev)
    with torch.no_grad():
        m, ph = eng.kernel_inputs(p)
    return m, ph, unit_states(b, 1 << eng.plan.hb, 1 << eng.plan.lb, gen, dev)


def block_main_inputs(bk, b, dev):
    """The 12q main path's plan and ``block_inputs`` at batch ``b``, from a
    generator of their own seeded with ``b``: the same inputs in phase 4
    and in ``--rates``, whatever ran before, on every tree."""
    import torch

    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    eng = bk.BlockKernelCircuit(DVCircuit(N_QUBITS, 1, "cross_mesh", seed=42))
    gen = torch.Generator(device=dev).manual_seed(b)
    return eng.plan, block_inputs(eng, b, gen, dev)


def hand_plan_inputs(bk, b, gen, dev):
    """HAND_PLAN at 12 qubits (6 hi bits) and its inputs: Haar-like random
    unitaries (QR of Gaussian matrices), random phases, ``unit_states``."""
    import torch

    steps, mats, diags = [], [], []
    for kind, axis in HAND_PLAN:
        if kind == "mat":
            steps.append(bk.KStep("mat", axis, len(mats)))
            mats.append((0, axis))
        else:
            steps.append(bk.KStep("diag", idx=len(diags)))
            diags.append(0)
    plan = bk.KPlan(12, 6, 6, tuple(steps), tuple(mats), tuple(diags))
    z = torch.randn(len(mats), 64, 64, 2, generator=gen, device=dev)
    q = torch.linalg.qr(torch.view_as_complex(z))[0]
    m = torch.stack([q.real, q.imag], dim=1).reshape(-1).contiguous()
    phi = 2 * math.pi * torch.rand(len(diags), 64, 64, generator=gen, device=dev)
    p = torch.stack([torch.cos(phi), torch.sin(phi)], dim=1).reshape(-1).contiguous()
    return plan, (m, p, unit_states(b, 64, 64, gen, dev))


def fwd_launch(bk, plan, b, dev):
    """K1's launch at batch ``b`` (``block_kernel.fwd_launch``, what the
    wrapper launches with): samples a tile, matrix buffers, shared bytes a
    CTA and grid."""
    import dataclasses

    return dataclasses.asdict(bk.fwd_launch(dev, plan, b))


def k1_tile_sweep(bk, plan, inputs, want, dev):
    """K1 on ``inputs`` at every tile of 1 to FWD_TILE samples that fits
    beside its matrix buffers, launched past the wrapper (so no launch is
    counted), each held to FWD_TOL against the plain version's ``want``
    and timed as phase 4 times K1 (events, the graph timer under 1 ms);
    ``same_as_launched`` says whether it is bit-equal to the tile the
    wrapper picks. Returns {T: row}."""
    import dataclasses

    import torch

    m, p, (xr, xi, _, _) = inputs
    picked = bk.fwd_launch(dev, plan, xr.shape[0])
    launched = bk.block_chain_fwd(xr, xi, m, p, plan)
    hl, km = 1 << plan.n, 1 << max(plan.hb, plan.lb)
    rows = {}
    for t in range(1, bk.FWD_TILE + 1):
        smem = 4 * (2 * t * hl + 2 * picked.matrix_buffers * km * km)
        if smem > bk.SMEM_MAX:
            continue
        launch = dataclasses.replace(
            picked, samples_per_tile=t, smem_per_cta=smem,
            grid=min(bk.grid_size(dev, xr.shape[0]), -(-xr.shape[0] // t)))
        y = torch.empty_like(xr), torch.empty_like(xi)

        def run():
            bk._launch_fwd(xr, xi, m, p, *y, plan, launch)

        run()
        torch.cuda.synchronize()
        err = max((a - r).abs().max().item() for a, r in zip(y, want))
        if not err <= FWD_TOL:
            raise SystemExit(f"block_chain_fwd T={t}: max abs err {err} > {FWD_TOL}")
        rows[t] = {"max_abs_err": err, "grid": launch.grid,
                   "same_as_launched": all(torch.equal(a, c) for a, c in zip(y, launched)),
                   **timed(run)}
    return rows


def check_block(bk, plan, inputs, tag):
    """Both block-chain wrappers (whichever pair the plan goes to) against
    the plain versions on ``inputs`` (``block_inputs``): forward <= FWD_TOL
    absolute, every backward output <= BWD_RTOL * max|ref|, each kernel
    bit-equal across two runs."""
    import torch

    m, ph, (xr, xi, gr, gi) = inputs
    mct = bk.conj_transpose(plan, m)
    got = bk.block_chain_fwd(xr, xi, m, ph, plan)
    rerun = bk.block_chain_fwd(xr, xi, m, ph, plan)
    want = bk.block_chain_fwd_ref(xr, xi, m, ph, plan)
    e_fwd = max((a - r).abs().max().item() for a, r in zip(got, want))
    bwd = bk.block_chain_bwd(*got, gr, gi, mct, ph, plan)
    again = bk.block_chain_bwd(*got, gr, gi, mct, ph, plan)
    ref = bk.block_chain_bwd_ref(*want, gr, gi, mct, ph, plan)
    torch.cuda.synchronize()
    e_abs = e_rel = 0.0
    for a, r in zip(bwd, ref):
        e, scale = (a - r).abs().max().item(), r.abs().max().item()
        if not e <= BWD_RTOL * scale:
            raise SystemExit(f"{tag}: block_chain_bwd err {e} > {BWD_RTOL} * {scale}")
        e_abs, e_rel = max(e_abs, e), max(e_rel, e / scale)
    if not e_fwd <= FWD_TOL:
        raise SystemExit(f"{tag}: block_chain_fwd err {e_fwd} > {FWD_TOL}")
    if not all(torch.equal(a, c) for a, c in zip(got, rerun)):
        raise SystemExit(f"{tag}: block_chain_fwd is not deterministic")
    if not all(torch.equal(a, c) for a, c in zip(bwd, again)):
        raise SystemExit(f"{tag}: block_chain_bwd is not deterministic")
    return {"fwd_abs": e_fwd, "bwd_abs": e_abs, "bwd_rel": e_rel}


def block_launch(bk, plan, b, dev):
    """The pair that runs ``plan`` and its launch shape at batch ``b``."""
    if not bk.uses_cluster_pair(plan):
        tile, bufs, smem = bk.bwd_config(plan)
        return {"pair": "12q",
                **{f"fwd_{k}": v for k, v in fwd_launch(bk, plan, b, dev).items()},
                "bwd_samples_per_tile": tile, "bwd_mct_buffers": bufs, "bwd_smem": smem}
    cfg = bk.cluster_config(plan)
    return {"pair": "cluster", "fwd_cluster": cfg.fwd_cluster,
            "bwd_cluster": cfg.bwd_cluster, "split": "H" if cfg.part_hi else "L",
            "fwd_smem": cfg.fwd_smem, "bwd_smem": cfg.bwd_smem}


def lib_chain(plan, xc, mats_c, ph_c):
    """The complex einsum chain of ``plan`` (cuBLAS, TF32 off): the library
    call that computes K1's function."""
    import torch

    s = xc
    for st in plan.steps:
        if st.kind == "mat":
            eq = "bkl,km->bml" if st.axis == "hi" else "bhk,km->bhm"
            s = torch.einsum(eq, s, mats_c[st.idx])
        else:
            s = s * ph_c[st.idx]
    return s


def complex_inputs(bk, plan, m, p, xr, xi):
    """The library's inputs: the state, the matrices and the phase planes
    as complex tensors."""
    import torch

    mats, phases = bk.unpack(plan, m, p)
    return (torch.complex(xr, xi), [torch.complex(a, c) for a, c in mats],
            [torch.complex(a, c) for a, c in phases])


def lib_chain_forward(plan, xc, mats_c, ph_c):
    """``autograd_timed``'s forward of ``lib_chain``: fresh leaves for the
    state, the matrices and the phase planes."""

    def forward():
        xg = xc.clone().requires_grad_(True)
        mg = [t.clone().requires_grad_(True) for t in mats_c]
        pg = [t.clone().requires_grad_(True) for t in ph_c]
        return lib_chain(plan, xg, mg, pg), [xg, *mg, *pg]

    return forward


def chain_work(bk, plan, b, m, p):
    """(forward flops, forward bytes, backward flops, backward bytes) of the
    block chain for B samples: a mat step is 8 H L K flops a sample (a
    complex multiply-add per output per k), a diag 6 H L; the backward
    recovers each step's input and pulls the cotangent back (twice the
    forward's products) and forms dM (a third), and does 20 H L a diag.
    Bytes: the states read and written once, the packed inputs, and the
    backward's slab of cotangents once per kernel."""
    h, l = 1 << plan.hb, 1 << plan.lb
    mat = sum(8 * h * l * plan.mat_dim(i) for i in range(plan.n_mats))
    state = 4 * b * h * l
    small = 4 * (m.numel() + p.numel())
    slab = 4 * (bk._step_table(plan)[1] + p.numel())
    return (b * (mat + 6 * h * l * plan.n_diags), 4 * state + small,
            3 * b * mat + 20 * b * h * l * plan.n_diags, 6 * state + small + slab)


def digest(tensors):
    """sha256 of the tensors' bytes, in order: equal digests, bit-equal
    outputs."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def k1_row(bk, plan, inputs, card_peaks, registers):
    """K1 (``block_chain_fwd``) on ``inputs`` (``block_main_inputs``)
    against its plain version (<= FWD_TOL, bit-equal across two runs),
    timed beside the plain version and the complex einsum chain, with its
    bound at a third of the TF32 tensor-core peak (3xTF32, what it runs
    on) beside the FP32 SIMT bound, its registers and the sha256 of its
    output. Returns the row, K1's output and the plain version's."""
    import torch

    m, p, (xr, xi, _, _) = inputs
    b = xr.shape[0]
    got = bk.block_chain_fwd(xr, xi, m, p, plan)
    rerun = bk.block_chain_fwd(xr, xi, m, p, plan)
    want = bk.block_chain_fwd_ref(xr, xi, m, p, plan)
    torch.cuda.synchronize()
    err = max((a - r).abs().max().item() for a, r in zip(got, want))
    if not err <= FWD_TOL:
        raise SystemExit(f"block_chain_fwd B={b}: max abs err {err} > {FWD_TOL}")
    if not all(torch.equal(a, c) for a, c in zip(got, rerun)):
        raise SystemExit(f"block_chain_fwd B={b} is not deterministic")
    xc, mats_c, ph_c = complex_inputs(bk, plan, m, p, xr, xi)
    f_ops, f_bytes, _, _ = chain_work(bk, plan, b, m, p)
    fb, fby = bound(f_ops, f_bytes, card_peaks, flop_rate=card_peaks[2] / 3)
    row = {
        "max_abs_err": err, "tol": FWD_TOL,
        **timed(lambda: bk.block_chain_fwd(xr, xi, m, p, plan)),
        "plain_ms": time_ms(lambda: bk.block_chain_fwd_ref(xr, xi, m, p, plan)),
        **timed(lambda: lib_chain(plan, xc, mats_c, ph_c), prefix="library_"),
        "library": "the complex einsum chain (cuBLAS, TF32 off)",
        "bound_ms": fb, "bound_by": fby, "bound_rate": TC_RATE,
        # the same work on the FP32 SIMT units, where K1 ran before
        "bound_fp32_ms": bound(f_ops, f_bytes, card_peaks)[0],
        "registers": registers.get("block_chain_fwd_kernel"),
        "sha256": digest(got),
    }
    return row, got, want


def sass_mma_counts(lib_path):
    """{kernel: tensor-core (HMMA) instructions in its SASS}, read by the
    toolkit's cuobjdump; None where the toolkit has none."""
    from qcpinn_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in ln:
            counts[fn] += 1
    return counts


def build_phase(names):
    """Phase ``build``: one nvcc per source, started together; each
    kernel's registers and spills (ptxas) and tensor-core instructions
    (``sass_mma_counts``). Returns cuda_build.build_all's result."""
    from qcpinn_tpu_torch.ops import cuda_build

    built = cuda_build.build_all(names)
    emit({"phase": "build", "sources": {
        f"qcpinn_tpu_torch/ops/csrc/{name}.cu": {
            "seconds": seconds, "library": os.path.relpath(path),
            "ptxas": [ln.strip() for ln in report.splitlines()
                      if "registers" in ln or "spill" in ln],
            "sass_hmma": sass_mma_counts(path)}
        for name, (path, seconds, report) in built.items()}})
    return built


def kernel_shapes_phase(dev, gen):
    """Phase ``kernel_shapes``: every BLOCK_SHAPES row and HAND_PLAN (at B =
    682 and B = 5) through both block-chain wrappers against the plain
    versions (check_block)."""
    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    shape_errs = {}
    for n, layers, hb, b in BLOCK_SHAPES:
        eng = bk.BlockKernelCircuit(
            DVCircuit(n, layers, "cross_mesh", seed=42 if n >= 7 else None), hi_bits=hb)
        tag = f"n{n}_hb{eng.plan.hb}_layers{layers}_B{b}"
        shape_errs[tag] = {**check_block(bk, eng.plan, block_inputs(eng, b, gen, dev), tag),
                           **block_launch(bk, eng.plan, b, dev)}
    for b in (682, 5):
        plan, inputs = hand_plan_inputs(bk, b, gen, dev)
        tag = f"hand_plan_{'_'.join(k + a for k, a in HAND_PLAN)}_B{b}"
        shape_errs[tag] = {**check_block(bk, plan, inputs, tag),
                           **block_launch(bk, plan, b, dev)}
    emit({"phase": "kernel_shapes", "tol": {"fwd_abs": FWD_TOL, "bwd": f"{BWD_RTOL}*max|ref|"},
          "results": shape_errs})


def cluster_kernels():
    """``--cluster-kernels``: build the block-chain sources, then the
    kernel_shapes and cluster_kernels phases alone (the cluster pair at
    every shape, and its times at 13 and 16 qubits)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    built = build_phase(["block_chain", "block_chain_cluster"])
    gen = torch.Generator(device=dev).manual_seed(7)
    kernel_shapes_phase(dev, gen)
    floor = launch_floor_phase()
    cluster_phase(dev, gen, peaks(torch.cuda.get_device_name(0)), smi,
                  ptxas_registers(built["block_chain_cluster"][2]), floor)
    print(smi, flush=True)


def rates(tree: str):
    """``--rates TREE``: with TREE's ``qcpinn_tpu_torch``, the rows of
    phase 4 and step_parity that compare two trees: the slab sums at the
    slab_sums phase's edge shapes, then at the main paths' shapes
    (``reduction_cases``, each a ``reduce_row``); K1 at the 12q main
    path's shapes (each a ``k1_row`` on ``block_main_inputs``) with the
    sha256 of K2's outputs on the same inputs (the backward kernel and its
    slab sum), so that two trees' K2 can be held bit-equal; and the 12q
    ``step_parity`` at each of STEP_SEEDS. One JSON line. To compare two
    trees, run it once per tree in one call, in turns (A, B, B, A)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(tree))
    import qcpinn_tpu_torch
    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops import cuda_build

    built = cuda_build.build_all(["block_chain", "block_chain_cluster", "gate_loop",
                                  "unrolled_sv"])
    registers = ptxas_registers(built["block_chain"][2])
    dev = torch.device("cuda")
    card_peaks = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(7)
    slab_sum_phase(dev, gen)
    floor = launch_floor_phase()
    slab_sums = {}
    for tag, partials, wrapper, ref in reduction_cases(dev, gen):
        slab_sums[tag] = reduce_row(wrapper, ref, partials, card_peaks, floor)
        del partials
        torch.cuda.empty_cache()
    k1 = {}
    for b in BLOCK_BATCHES:
        plan, inputs = block_main_inputs(bk, b, dev)
        m, p, states = inputs
        k1[b], _, _ = k1_row(bk, plan, inputs, card_peaks, registers)
        k2 = bk.block_chain_bwd(*states, bk.conj_transpose(plan, m), p, plan)
        k1[b]["k2_sha256"] = digest(k2)
        del inputs, states, k2
        torch.cuda.empty_cache()
    parity = {seed: step_parity(bench, N_QUBITS, "block_kernel", seed)
              for seed in STEP_SEEDS}
    emit({"tree": tree, "package": os.path.dirname(qcpinn_tpu_torch.__file__),
          "slab_sums": slab_sums, "block_chain_fwd": k1, "step_parity": parity,
          "registers": registers, "card": nvidia_smi_line()})


def cluster_phase(dev, gen, card_peaks, smi, registers, floor):
    """Phase ``cluster_kernels``; returns its results by (n, B). ``floor``:
    the launch floor (ms)."""
    import torch

    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    out = {}
    for n, batches in CLUSTER_SHAPES:
        eng = bk.BlockKernelCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
        plan = eng.plan
        cfg = bk.cluster_config(plan)
        for b in batches:
            tag = f"{n}q_B{b}"
            m, p, states = block_inputs(eng, b, gen, dev)
            xr, xi, gr, gi = states
            errs = check_block(bk, plan, (m, p, states), tag)
            mct = bk.conj_transpose(plan, m)
            y = bk.block_chain_fwd(xr, xi, m, p, plan)
            y_ref = bk.block_chain_fwd_ref(xr, xi, m, p, plan)
            xc, mats_c, ph_c = complex_inputs(bk, plan, m, p, xr, xi)
            f_ops, f_bytes, b_ops, b_bytes = chain_work(bk, plan, b, m, p)
            # the products run on tensor cores in 3xTF32: three TF32 passes
            # per f32 product
            tc = card_peaks[2] / 3
            fb, fby = bound(f_ops, f_bytes, card_peaks, flop_rate=tc)
            bb, bby = bound(b_ops, b_bytes, card_peaks, flop_rate=tc)
            reps = 5 if n == 16 else TIME_REPS
            row = {"fwd": {
                "max_abs_err": errs["fwd_abs"], "tol": FWD_TOL,
                **timed(lambda: bk.block_chain_fwd(xr, xi, m, p, plan), reps=reps),
                "plain_ms": time_ms(lambda: bk.block_chain_fwd_ref(xr, xi, m, p, plan),
                                    reps=5),
                **timed(lambda: lib_chain(plan, xc, mats_c, ph_c), reps=reps,
                        prefix="library_"),
                "library": "the complex einsum chain (cuBLAS, TF32 off)",
                "bound_ms": fb, "bound_by": fby, "bound_rate": TC_RATE,
                "bound_fp32_ms": bound(f_ops, f_bytes, card_peaks)[0],
                "cluster": cfg.fwd_cluster, "smem_per_cta": cfg.fwd_smem,
                "grid_clusters": min(b, bk.max_clusters(dev, plan, bwd=False)),
                "registers": registers.get("block_cluster_fwd_kernel"),
            }}
            gc = torch.complex(gr, gi)
            _, _, partials = bk.block_chain_bwd_partials(*y, gr, gi, mct, p, plan)
            kern = timed(lambda: bk.block_chain_bwd_partials(*y, gr, gi, mct, p, plan),
                         reps=reps)
            row["bwd"] = {
                "max_abs_err": errs["bwd_abs"], "max_rel_err": errs["bwd_rel"],
                "tol": f"{BWD_RTOL}*max|ref|", **kern,
                "plain_ms": time_ms(lambda: bk.block_chain_bwd_ref(
                    *y_ref, gr, gi, mct, p, plan), reps=5),
                **autograd_timed(lib_chain_forward(plan, xc, mats_c, ph_c), gc,
                                 "graph_ms" in kern, reps=reps),
                "library": "autograd backward alone of the complex einsum chain",
                "bound_ms": bb, "bound_by": bby, "bound_rate": TC_RATE,
                "bound_fp32_ms": bound(b_ops, b_bytes, card_peaks)[0],
                "cluster": cfg.bwd_cluster, "smem_per_cta": cfg.bwd_smem,
                "grid_clusters": partials.shape[0],
                "registers": registers.get("block_cluster_bwd_kernel"),
            }
            row["reduce"] = reduce_row(bk.block_chain_reduce, bk.block_chain_reduce_ref,
                                       partials, card_peaks, floor)
            out[tag] = row
            del y, y_ref, gc, xc, mats_c, ph_c, states, partials
            torch.cuda.empty_cache()
    emit({"phase": "cluster_kernels", "card": smi, "results": out})
    return out


def stage2_parity(args, dev, backend):
    """One north-star stage-2 step through ``backend`` against the same step
    on the plain block engine (RBF head, same weights and points): loss rtol
    2e-5, every grad atol 2e-4 * max(|ref|, 1e-3)."""
    import torch

    from qcpinn_tpu_torch import north_star as ns
    from qcpinn_tpu_torch.train import optim as topt
    from qcpinn_tpu_torch.train.loop import TermSpec

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
    for name in (backend, "block"):
        st = NorthStarStepper(args, name, dev, eager=True, state_dict=sd,
                              terms=fixed, optimizer=opt)
        sd = sd or {k: v.clone() for k, v in st.model.state_dict().items()}
        losses[name] = st.step().item()
        grads[name] = dict(zip([k for k, p in st.model.named_parameters()
                                if p.requires_grad], captured["g"]))
        del st
        torch.cuda.empty_cache()
    if not math.isclose(losses[backend], losses["block"], rel_tol=2e-5):
        raise SystemExit(f"16q step loss {losses}")
    worst = {}
    for k, ref in grads["block"].items():
        scale = max(ref.abs().max().item(), 1e-3)
        e = (grads[backend][k] - ref).abs().max().item()
        if not e <= 2e-4 * scale:
            raise SystemExit(f"16q step grad {k} ({backend}): {e} > 2e-4 * {scale}")
        worst[k] = e / scale
    return {f"loss_{backend}": losses[backend], "loss_block": losses["block"],
            "max_grad_err_over_scale": max(worst.values())}


def north_star_block_phase(dev, smi):
    """Phase ``north_star_block``; returns the launch counters of the
    graphed stage-2 run (the block_kernel main path)."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

    args = ns.parse_args(NORTH_STAR_ARGS)
    parity = stage2_parity(args, dev, "block_kernel")
    ref = NorthStarStepper(args, "block_kernel", dev, eager=True)
    l_ref = ref.steps(GRAPH_PARITY_STEPS).tolist()
    got = NorthStarStepper(args, "block_kernel", dev)
    if not isinstance(got.model.qblock, bk.BlockKernelCircuit):
        raise SystemExit(f"north_star_block: engine {type(got.model.qblock).__name__}")
    torch.cuda.synchronize()
    bk.reset_launches()
    l_got = got.steps(GRAPH_PARITY_STEPS).tolist()
    torch.cuda.synchronize()
    launches = dict(bk.LAUNCHES)
    g = got.graph
    seen = g.eager_steps + g.captured
    for k in ("block_cluster_fwd", "block_cluster_bwd", "block_chain_reduce"):
        if launches[k] != 2 * seen:
            raise SystemExit(f"north_star_block: {k} launched {launches[k]} times "
                             f"in {seen} steps the counters see")
    for k in ("block_chain_fwd", "block_chain_bwd", "block_chain_fwd_ref",
              "block_chain_bwd_ref", "block_chain_reduce_ref"):
        if launches[k] != 0:
            raise SystemExit(f"north_star_block: {k} ran {launches[k]} times")
    graph = graph_parity("north_star_block", ref, got, l_ref, l_got)
    if not graph["bit_equal"]:  # the cluster pair is deterministic
        raise SystemExit(f"north_star_block: replays not bit-equal to eager: {graph}")
    del ref, got, g
    torch.cuda.empty_cache()
    rates = {"block_kernel": [], "loop": []}
    profiles = {}
    for backend in ("block_kernel", "loop", "loop", "block_kernel"):
        st = NorthStarStepper(args, backend, dev)
        st.steps(WARMUP_STEPS + 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        float(st.steps(RATE_STEPS)[-1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / RATE_STEPS
        rates[backend].append({"ms_per_step": 1e3 * dt, "points_per_sec": args.batch / dt})
        if backend not in profiles:
            profiles[backend] = bench.profile(st, 1e3 * dt, steps=3, top=8)
        del st
        torch.cuda.empty_cache()
    emit({"phase": "north_star_block", "step_parity": parity, "graph": graph,
          "launches": launches, "rates": rates, "profiles": profiles, "card": smi})
    return launches


def k4b_probe(dev, gen, when):
    """Phase ``k4b_probe``: K3, K4 and K4b, and torch.sum over K4b's slabs,
    at the 8q main path's stream batch (the evolve of B = 6144 rows), by
    events and by graph."""
    import torch

    from qcpinn_tpu_torch.ops import sv_kernel as sk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    circ = DVCircuit(SV_QUBITS, 1, "cross_mesh", seed=42)
    mp, _, _, banks, (xr, xi, gr, gi) = sv_inputs(sk, circ, SV_BATCHES[0][0], "evolve",
                                                  gen, dev)
    y = sk.unrolled_fwd(xr, xi, *banks, mp)
    partials = sk.unrolled_bwd_partials(*y, gr, gi, *banks, mp)[-1]
    row = {"phase": "k4b_probe", "when": when, "batch": SV_BATCHES[0][0],
           "slabs": list(partials.shape)}
    for key, fn in (
            ("unrolled_fwd", lambda: sk.unrolled_fwd(xr, xi, *banks, mp)),
            ("unrolled_bwd", lambda: sk.unrolled_bwd_partials(*y, gr, gi, *banks, mp)),
            ("unrolled_reduce", lambda: sk.unrolled_reduce(partials)),
            ("torch_sum", lambda: torch.sum(partials, dim=0))):
        row[f"{key}_ms"] = time_ms(fn)
        row[f"{key}_graph_ms"] = graph_ms(fn)
    row["card"] = nvidia_smi_line()
    emit(row)
    del y, partials, xr, xi, gr, gi
    torch.cuda.empty_cache()
    return row


def main():
    import torch

    t_start = time.perf_counter()

    if len(sys.argv) == 3 and sys.argv[1] == "--stage2-rate":
        return stage2_rate(sys.argv[2])
    if sys.argv[1:] == ["--loop-step-costs"]:
        return loop_step_costs()
    if sys.argv[1:] == ["--unrolled-step-costs"]:
        return unrolled_step_costs()
    if sys.argv[1:] == ["--cluster-kernels"]:
        return cluster_kernels()
    if len(sys.argv) == 3 and sys.argv[1] == "--rates":
        return rates(sys.argv[2])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)
    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.ops import block_kernel as bk

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
    built = build_phase(["block_chain", "block_chain_cluster", "gate_loop",
                         "unrolled_sv"])

    # -- 3. every configuration of the block-chain kernels -------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    kernel_shapes_phase(dev, gen)
    slab_sum_phase(dev, gen)
    floor = launch_floor_phase()
    k4b_before = k4b_probe(dev, gen, "before the 16q phases")

    # -- 4. kernels vs plain versions at the main path's shapes ------------
    registers = ptxas_registers(built["block_chain"][2])
    per_kernel = {"block_chain_fwd": {}, "block_chain_bwd": {},
                  "block_chain_reduce": {}}
    for b in BLOCK_BATCHES:
        plan, inputs = block_main_inputs(bk, b, dev)
        m, p, (xr, xi, gr, gi) = inputs
        mct = bk.conj_transpose(plan, m)

        # K1 forward
        row, (yr, yi), (ryr, ryi) = k1_row(bk, plan, inputs, card_peaks, registers)
        per_kernel["block_chain_fwd"][b] = {
            **row, **fwd_launch(bk, plan, b, dev),
            "tile_sweep": k1_tile_sweep(bk, plan, inputs, (ryr, ryi), dev)}

        # K2 backward (kernel alone) + the reduction
        gxr, gxi, partials = bk.block_chain_bwd_partials(
            yr, yi, gr, gi, mct, p, plan)
        red = bk.block_chain_reduce(partials)
        out = bk.block_chain_bwd_ref(ryr, ryi, gr, gi, mct, p, plan)
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
        if not (torch.equal(gxr, got[0]) and torch.equal(gxi, got[1])
                and torch.equal(red, torch.cat([got[2], got[3]]))):
            raise SystemExit("block_chain_bwd is not deterministic")
        _, _, bwd_flops, bwd_bytes = chain_work(bk, plan, b, m, p)
        # three complex products a mat step: the inputs hold no forward
        # state, so each step's input is recovered (one product) before dM
        # and the pullback (two more); K2 runs them on tensor cores in
        # 3xTF32, three TF32 passes per f32 product
        bb, bby = bound(bwd_flops, bwd_bytes, card_peaks, flop_rate=card_peaks[2] / 3)
        tile, bufs, bwd_smem = bk.bwd_config(plan)
        xc, mats_c, ph_c = complex_inputs(bk, plan, m, p, xr, xi)
        kern = timed(lambda: bk.block_chain_bwd_partials(yr, yi, gr, gi, mct, p, plan))
        per_kernel["block_chain_bwd"][b] = {
            "max_abs_err": err, "max_rel_err": worst, "tol": f"{BWD_RTOL}*max|ref|",
            **kern,
            "plain_ms": time_ms(lambda: bk.block_chain_bwd_ref(
                ryr, ryi, gr, gi, mct, p, plan)),
            # the library's backward alone: its graph is built once, outside
            # the timed calls, as the kernel's forward is outside K2's time
            **autograd_timed(lib_chain_forward(plan, xc, mats_c, ph_c),
                             torch.complex(gr, gi), "graph_ms" in kern),
            "library": "autograd backward alone of the complex einsum chain",
            "bound_ms": bb, "bound_by": bby,
            "bound_rate": TC_RATE,
            # the same work on the FP32 SIMT units, as the kernel before
            # the tensor cores ran it
            "bound_fp32_ms": bound(bwd_flops, bwd_bytes, card_peaks)[0],
            "grid": partials.shape[0], "samples_per_tile": tile,
            "mct_buffers": bufs, "smem_per_cta": bwd_smem,
            "registers": registers.get("block_chain_bwd_kernel"),
        }
        per_kernel["block_chain_reduce"][b] = reduce_row(
            bk.block_chain_reduce, bk.block_chain_reduce_ref, partials, card_peaks, floor)
        del inputs, xr, xi, gr, gi, yr, yi, ryr, ryi, out, got, partials, red, xc
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "n_qubits": N_QUBITS, "card": smi,
          "results": per_kernel})

    # -- 5. one train step: kernels vs the plain block engine --------------
    emit({"phase": "step_parity", "by_seed": {
        seed: step_parity(bench, N_QUBITS, "block_kernel", seed) for seed in STEP_SEEDS}})

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
    stage1_jet_phase(dev, smi)
    torch.cuda.empty_cache()

    # -- 7-10. the 16q north-star path through the gate-loop kernels ---------
    loop_results = loop_phases(dev, gen, card_peaks, smi,
                               ptxas_registers(built["gate_loop"][2]), floor)
    torch.cuda.empty_cache()

    # -- 16-17. the cluster pair at 13-16 qubits and on the 16q stage 2 ----
    cluster = cluster_phase(dev, gen, card_peaks, smi,
                            ptxas_registers(built["block_chain_cluster"][2]), floor)
    torch.cuda.empty_cache()
    ns_block_launches = north_star_block_phase(dev, smi)
    torch.cuda.empty_cache()

    # -- 11-15. the 8q main path and the plain solver through K3/K4 ----------
    unrolled_results = unrolled_phases(dev, gen, card_peaks, smi,
                                       ptxas_registers(built["unrolled_sv"][2]), floor)
    k4b_after = k4b_probe(dev, gen, "after the 16q phases")
    emit({"phase": "k4b_question", **{
        f"{key}_{when}": row[key] for when, row in (("before", k4b_before),
                                                    ("after", k4b_after))
        for key in ("unrolled_reduce_ms", "unrolled_reduce_graph_ms", "torch_sum_ms",
                    "torch_sum_graph_ms")}})

    sources = {
        "block_chain_fwd": "qcpinn_tpu/ops/block_pallas.py:189",
        "block_chain_bwd": "qcpinn_tpu/ops/block_pallas.py:222",
        "block_chain_reduce": "qcpinn_tpu/ops/block_pallas.py:241",
    }
    main_b = BLOCK_BATCHES[0]
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
            **{key: r[key] for key in GRAPH_KEYS if key in r},
            "batch": main_b,
            **{key: r[key] for key in ("bound_rate", "bound_fp32_ms", "samples_per_tile",
                                       "grid", "smem_per_cta", "registers")
               if key in r},
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    # K2b on the cluster pair's slabs (its launches on that path are counted
    # in north_star_block)
    kernels[-1]["cluster_slabs"] = {tag: row["reduce"] for tag, row in cluster.items()}
    # the cluster pair: its launches on the block_kernel stage-2 path
    for k, part, src in (("block_cluster_fwd", "fwd", "qcpinn_tpu/ops/block_pallas.py:189"),
                         ("block_cluster_bwd", "bwd", "qcpinn_tpu/ops/block_pallas.py:222")):
        by_b = {tag: row[part] for tag, row in cluster.items()}
        r = by_b[f"16q_B{LOOP_BATCHES[0]}"]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/block_chain_cluster.cu",
            "replaces": src, "launches": ns_block_launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in GRAPH_KEYS if key in r},
            "batch": LOOP_BATCHES[0], "n_qubits": 16,
            **{key: r[key] for key in ("bound_rate", "bound_fp32_ms", "cluster",
                                       "smem_per_cta", "registers", "grid_clusters")},
            "by_shape": by_b,
        })
    kernels += loop_results + unrolled_results
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
