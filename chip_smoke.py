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
               K4b; both on their warp routes at n <= 9, their tile
               routes, a segment of the program a barrier, above)
               against their plain versions, with the encoding (from
               |0...0>) and evolve-only: cross_mesh n = 1, 2, 4, 7, 8, 9,
               10, 12, cascade n = 3 (2 layers), 8 and 9 (controlled gates,
               Haar u2q), alternate n = 5 and 6 (u2q on lane bits, 4-5
               phase rows), layered n = 8 with 3 layers, an
               amplitude-encoded evolve at n = 8, B = 37 and B = 1: forward
               <= 3e-5 absolute on unit-norm states (tests/test_pallas_sv.py),
               backward <= 2e-4 * max|ref| per output, bit-equal across two
               runs.
12. unrolled_kernels K3, K4 and K4b on the warp routes at the 8q main
               path's shapes (the evolve of B = 6144 stream rows, the apply
               of B = 682 value rows), with the tile routes on the same
               inputs beside them, and on the tile routes at the 10q
               north_star_plain shapes (B = 1536 and 425); same limits,
               with times beside the plain versions and the plain block
               engine's einsum chain (K3) or its autograd backward (K4),
               all graph-timed, the launch (warps or threads, shared
               memory, grid, CTAs an SM), the segments and the registers.
13. step_parity_8q one 8q bench step through ``unrolled`` against the plain
               block engine; limits as in 5.
14. train_8q   the 8q main path: the bench train step at 8 qubits (``auto``
               picks FusedCircuit), a captured CUDA graph, driven as in 6
               with the launch counters set to 0 just before: every loss finite,
               K3 and K4 on their warp routes and K4b launched exactly twice
               in each step the counters see, the tile routes and no plain
               version called; then a torch.profiler window.
15. north_star_plain ``north_star.run`` with --solver plain (DVSolver, one
               stage) at 10 qubits, B = 256, hidden 64, --backend unrolled,
               50 steps, then the 20^3 evaluation by streams: every loss
               finite, K3's tile route launched twice per step the counters
               see and twice per evaluation chunk, K4's tile route and K4b
               twice per step they see, the warp routes and no plain
               version called.

6d. cli_train  the README's entry point, ``cli.main(["train", ...])`` on the
               card with --no-plots, CLI_EPOCHS epochs each, for CLI_RUNS: DV
               cascade 4q diffusion (hidden 50, B = 64, seed 1), Classical
               (Hopfield) diffusion with --best-val, DV layered 8q helmholtz,
               DV sim_circ_15 8q wave, DV navier_stokes with --loss-balancer
               ema. Each: its train step (``train/loop.py::train_stage``,
               the CLI's own model, terms and operator) graphed against the
               same step eager from the same seed, 5 steps (3 eager
               warm-ups, the capture, a replay), limits as in 6b; the eager
               ms a step (its last 4 steps), the graphed one (10 replays)
               with its launches, device time and idle share (a 3-step
               profile); the CLI run with every kernel and plain-version launch
               counter set to 0 just before and all still 0 after (the
               path runs no kernel of the package, as in JAX); its final
               loss, rel-L2 and trainable parameters (717 and 7,751 where
               the JAX records give them); the checkpoint reloaded into a
               fresh model, whose rel-L2 on the same grid is bit-equal to
               the run's.
6e. north_star_classical ``north_star.run`` with --solver classical (the
               Hopfield baseline, one stage, 100 steps), the 20^3
               evaluation: every loss finite, the kernel counters at 0.
6f. hw_modes   the hardware-fidelity modes: (a) the noisy readout
               (HW_NOISE: depolarizing, readout and depth-aware per-gate)
               through each engine with a kernel at its main path's value
               rows (HW_ENGINES: block_kernel 12q, K1/K2/K2b; unrolled 8q and
               10q, K3/K4/K4b on the warp and tile routes; loop 16q,
               K5/K6/K6b) against the plain block engine with the same
               channel: forward within the engine's limit, the gradients
               of params and inputs within 2e-4 * max|ref|, then a
               sampled readout (1024 shots) by the binomial law, every
               kernel launched and no plain version (the kernels line's
               ``hw_modes_launches``); (b) ``measure.sampled_z`` in a
               captured step, 64 draws a replay, two replays each by the
               law and different; (c) parameter-shift against autograd
               (DV cascade 4q, cross_mesh 8q, atol 2e-4); (d) each
               gradient mode's ``cli train`` step (DV cascade 4q) graphed
               against eager: bit-equal over 5 steps with shots=None,
               means within 3 standard errors over 20 steps with shots,
               ms a step, launches and idle share; (e) the two JAX
               records' SPSA commands (artifacts/spsa_ab_*.json) at 300
               epochs, kernel counters 0.
6g. cz         the Czochralski flagship (no kernel of the package on this
               path; every counter 0): ``cli.main(["cz", "--phase", "eval",
               ...])`` of artifacts/cz_real_wide384_400 (--trunk-width 384)
               and cz_real_balanced on data/cz_melt_raw.txt, each field's
               rel-L2 within 1% and val_mse within 2% of JAX's own
               evaluation of the checkpoint (CZ_JAX_CPU_EVAL; the TPU
               records, 1.1-2.3x below it, beside); the pretrain step of the
               wide384_400 record's command (16q, trunk 384, B = 256,
               balanced, physics engaged) graphed against eager over 5 steps,
               bit-equal (losses, parameters, EMA state), ms a step, a
               profile of each (launches, device ms, idle share), the peak
               memory of each, and the peak at B = 512 with remat (the
               forward-mode residual in chunks of 256 rows); head- and
               full-scope finetune steps from that checkpoint at --shots
               4096 --calib-size 8 with the ft_noise record's noise, graphed
               against eager (means within 3 standard errors over 10 sampled
               steps), ms a step, the circuit evaluations a step (289 in full
               scope) and the leaves that moved.
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

Measurements beside the smoke test:

    python3 chip_smoke.py --stage2-rate TREE   # the 16q stage-2 step of TREE's package
    python3 chip_smoke.py --loop-step-costs    # K5/K6 time per step kind at 16q
    python3 chip_smoke.py --unrolled-step-costs  # K3/K4 per step kind and segment, 8q and 10q
    python3 chip_smoke.py --cluster-kernels    # build, kernel_shapes, cluster_kernels
    python3 chip_smoke.py --rates TREE         # TREE's rows of phase 4 and step_parity
    python3 chip_smoke.py --unrolled           # build, unrolled_shapes, unrolled_kernels
    python3 chip_smoke.py --sv-rates TREE      # TREE's K3/K4, their digests, 8q and 10q steps
    python3 chip_smoke.py --cli-train          # device, cli_train, north_star_classical
    python3 chip_smoke.py --hw-modes           # the JAX SPSA records at 3000 epochs,
                                               # parameter-shift at --shots 1024
    python3 chip_smoke.py --cz-phase           # device, cz
    python3 chip_smoke.py --cz                 # JAX's Cz records: the six checkpoints'
                                               # evals, the three finetune records'
                                               # commands, the balanced pretrain
                                               # under a 20-minute budget
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


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
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
    # the tile route with controlled gates (cascade), with the phase rows
    # read through __ldg (layered, 2 layers: the slab in shared memory) and
    # with the slab in the partials too (alternate: 11 phase rows)
    (12, "cascade", 1, 11, "angle", 37), (12, "layered", 2, 42, "angle", 37),
    (12, "alternate", 1, 42, "angle", 37),
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
# the 8q main path's kernels: K3 and K4 on their warp routes, K4b
SV_NAMES = ("unrolled_fwd_warp", "unrolled_bwd_warp", "unrolled_reduce")
# the tile routes (10 <= n <= 12) on their main path, north_star_plain at 10
# qubits: the evolve of 6 x 256 stream rows, the apply of 5 x 85 value rows
SV_TILE_QUBITS = 10
SV_TILE_BATCHES = ((6 * 256, "evolve"), (5 * (256 // 3), "apply"))
SV_TILE_NAMES = ("unrolled_fwd_tile", "unrolled_bwd_tile", "unrolled_reduce")
# the plain version a kernel's launch counter is held against, where it is
# not the kernel's name with _ref (each direction's two routes share one)
PLAIN_NAME = {"unrolled_fwd_warp": "unrolled_fwd_ref", "unrolled_fwd_tile": "unrolled_fwd_ref",
              "unrolled_bwd_warp": "unrolled_bwd_ref", "unrolled_bwd_tile": "unrolled_bwd_ref"}
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


def unrolled_phases(dev, gen, card_peaks, smi, registers, floor, main_paths=True):
    """Phases 11-15 (11-12 without ``main_paths``); returns the
    K3/K4/reduction rows of the summary line. ``registers``: ptxas's count
    per kernel of unrolled_sv.cu; ``floor``: the launch floor (ms)."""
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

    # -- 12. unrolled_kernels at the 8q main path's shapes (the warp routes),
    # and at the 10q main path's (north_star_plain: the tile routes)
    per_kernel = {k: {} for k in (*SV_NAMES, *SV_TILE_NAMES)}
    for n_q, batches in ((SV_QUBITS, SV_BATCHES), (SV_TILE_QUBITS, SV_TILE_BATCHES)):
        circ = DVCircuit(n_q, 1, "cross_mesh", seed=42)
        blk = BlockFusedCircuit(circ)
        d = 1 << circ.n
        hl = (1 << blk.hb, 1 << blk.lb)
        warp_route = sk.route(n_q) == "warp"
        fwd_name, bwd_name = ("unrolled_fwd_warp", "unrolled_bwd_warp") if warp_route else (
            "unrolled_fwd_tile", "unrolled_bwd_tile")
        for b, mode in batches:
            mp, params, x, banks, states = sv_inputs(sk, circ, b, mode, gen, dev)
            errs, y, y_ref = check_sv(sk, mp, banks, states, f"{n_q}q_B{b}")
            xr, xi, gr, gi = states
            bank_bytes = 4 * sum(t.numel() for t in banks)
            f_ops, b_ops = step_work(lk, sk.steps(mp), mp.n, b)
            k, p, u = banks[0].shape[1], banks[2].shape[0], banks[4].shape[0]
            launch = (dict(zip(("warps_per_cta", "smem_per_cta", "grid", "ctas_per_sm"),
                               sk.warp_config(dev, mp.n, k, p, u, b, bwd=False)))
                      if warp_route else sk.tile_config(dev, mp, k, p, u, b, False).__dict__)
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
                kern = timed(lambda: sk.unrolled_fwd(xr, xi, *banks, mp))
                per_kernel[fwd_name][b] = {
                    "n_qubits": n_q, "mode": mode, "max_abs_err": errs["fwd_abs"],
                    "tol": SV_FWD_TOL, **kern,
                    "plain_ms": time_ms(
                        lambda: sk.unrolled_fwd_ref(xr, xi, *banks, mp), reps=5),
                    **timed(lib_fwd, reps=10, prefix="library_", graph="graph_ms" in kern),
                    "library": "the block engine's complex einsum chain, matrices "
                               "and phases built once (cuBLAS, TF32 off)"
                               + ("; with the product-state encoding"
                                  if mode == "apply" else ""),
                    "bound_ms": fb, "bound_by": fby, **launch,
                    "segments": len(sk.segments(mp)), "steps": len(mp.steps),
                    "registers": registers.get(
                        f"unrolled_fwd_warp_kernel_rb{max(mp.n - 5, 0)}" if warp_route
                        else "unrolled_fwd_tile_kernel" + ("" if launch["rows"] else "_ldg")),
                }
                if warp_route:  # the tile route on the same inputs
                    per_kernel[fwd_name][b].update(timed(
                        lambda: sk.unrolled_fwd_tile(xr, xi, *banks, mp), prefix="tile_route_",
                        graph="graph_ms" in kern))
            bwd = sk.unrolled_bwd_partials
            gxr, gxi, gmre, gmim, partials = bwd(*y, gr, gi, *banks, mp)
            out_bytes = 4 * (gmre.numel() + gmim.numel() + banks[2].numel()
                             + banks[3].numel())
            bb, bby = bound(b_ops, 4 * 6 * b * d + bank_bytes + out_bytes, card_peaks)
            # the library's backward alone, on the prepared state: its graph
            # is built once, outside the timed calls, as the kernel's forward
            # is outside K4's time
            gc = torch.complex(gr, gi).reshape(b, *hl)
            kern = timed(lambda: bwd(*y, gr, gi, *banks, mp))
            row = {
                "n_qubits": n_q, "mode": mode, "max_abs_err": errs["bwd_abs"],
                "max_rel_err": errs["bwd_rel"], "tol": f"{BWD_RTOL}*max|ref|", **kern,
                "plain_ms": time_ms(
                    lambda: sk.unrolled_bwd_ref(*y_ref, gr, gi, *banks, mp), reps=5),
                **autograd_timed(chain_forward(ops, torch.complex(xr, xi).reshape(b, *hl)),
                                 gc, "graph_ms" in kern, reps=10),
                "library": "autograd backward alone of that einsum chain (no encoding)",
                "bound_ms": bb, "bound_by": bby, "grid": partials.shape[0],
                "segments": len(sk.segments(mp)), "steps": len(mp.steps),
            }
            if warp_route:
                warps, smem, _, blocks = sk.warp_config(dev, mp.n, k, p, u, b)
                row.update({
                    "warps_per_cta": warps, "smem_per_cta": smem, "ctas_per_sm": blocks,
                    "registers": registers.get(f"unrolled_bwd_warp_kernel_rb{mp.n - 5}"),
                    # the tile route on the same inputs
                    **timed(lambda: sk.unrolled_bwd_cta_partials(*y, gr, gi, *banks, mp),
                            prefix="tile_route_", graph="graph_ms" in kern),
                })
            else:
                cfg = sk.tile_config(dev, mp, k, p, u, b, True)
                row.update({**cfg.__dict__, "registers": registers.get(
                    "unrolled_bwd_tile_kernel" + {3: "", 2: "_ldg", 0: "_global"}[cfg.variant])})
            per_kernel[bwd_name][b] = row
            per_kernel["unrolled_reduce"][b] = reduce_row(
                sk.unrolled_reduce, sk.unrolled_reduce_ref, partials, card_peaks, floor)
            del ops, y, y_ref, gxr, gxi, gmre, gmim, partials, gc, states
            torch.cuda.empty_cache()
    emit({"phase": "unrolled_kernels", "n_qubits": SV_QUBITS,
          "tile_route_qubits": SV_TILE_QUBITS, "card": smi, "results": per_kernel})

    if not main_paths:
        return []

    # -- 13. step_parity_8q: unrolled vs the plain block engine ----------------
    emit({"phase": "step_parity_8q", **step_parity(bench, SV_QUBITS, "unrolled")})

    # -- 14. train_8q: the 8q main path, the bench train step -----------------
    trainer = bench.build(n_qubits=SV_QUBITS)
    if not isinstance(trainer.model._fused, sk.FusedCircuit):
        raise SystemExit(f"auto picked {type(trainer.model._fused).__name__} at 8q")
    launches, row = run_train(trainer, sk, SV_NAMES)
    for k in ("unrolled_fwd_tile", "unrolled_bwd_tile"):
        if launches[k] != 0:
            raise SystemExit(f"train_8q: the tile route {k} ran {launches[k]} times")
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
    want = {"unrolled_fwd_tile": 2 * seen + 2 * eval_chunks, "unrolled_bwd_tile": 2 * seen,
            "unrolled_reduce": 2 * seen, "unrolled_fwd_warp": 0, "unrolled_bwd_warp": 0}
    for k, v in want.items():
        if ns_launches[k] != v:
            raise SystemExit(f"north_star_plain: {k} launched {ns_launches[k]}, want {v}")
        if ns_launches[PLAIN_NAME.get(k, f"{k}_ref")] != 0:
            raise SystemExit(f"north_star_plain: the plain version of {k} ran")
    emit({"phase": "north_star_plain", "result": result, "wall_s": wall,
          "launches": ns_launches, "card": smi})

    sources = {"unrolled_fwd_warp": "qcpinn_tpu/ops/pallas_sv.py:284",
               "unrolled_fwd_tile": "qcpinn_tpu/ops/pallas_sv.py:284",
               "unrolled_bwd_warp": "qcpinn_tpu/ops/pallas_sv.py:317",
               "unrolled_bwd_tile": "qcpinn_tpu/ops/pallas_sv.py:317",
               "unrolled_reduce": "qcpinn_tpu/ops/pallas_sv.py:332"}
    rows = []
    for k, by_b in per_kernel.items():
        # the tile routes: their launches and shapes on north_star_plain (10q)
        tile = k.endswith("_tile")
        main_b = (SV_TILE_BATCHES if tile else SV_BATCHES)[0][0]
        r = by_b[main_b]
        rows.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/unrolled_sv.cu",
            "replaces": sources[k], "launches": (ns_launches if tile else launches)[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in GRAPH_KEYS if key in r},
            "batch": main_b, "n_qubits": SV_TILE_QUBITS if tile else SV_QUBITS,
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

    if isinstance(st, (NorthStarStepper, CliStepper)):
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


CLI_EPOCHS = 200
# (tag, train flags, the trainable count of the JAX record, where there is one)
CLI_RUNS = (
    ("dv_cascade_4q_diffusion", ["--problem", "diffusion", "--solver", "DV", "--ansatz",
                                 "cascade", "--num-qubits", "4", "--hidden-dim", "50",
                                 "--batch-size", "64", "--seed", "1"], 717),
    ("classical_diffusion_best_val", ["--problem", "diffusion", "--solver", "Classical",
                                      "--batch-size", "64", "--seed", "1", "--best-val"],
     7751),
    ("dv_layered_8q_helmholtz", ["--problem", "helmholtz", "--ansatz", "layered",
                                 "--num-qubits", "8"], None),
    ("dv_sim_circ_15_8q_wave", ["--problem", "wave", "--ansatz", "sim_circ_15",
                                "--num-qubits", "8"], None),
    ("dv_navier_stokes_ema", ["--problem", "navier_stokes", "--loss-balancer", "ema"], None),
)


class CliStepper:
    """The train step of ``cli train FLAGS`` (its model, terms and operator,
    set up by ``train/loop.py::train_stage`` as ``train`` sets it up), on a
    fresh model from the flags' seed. ``steps(n)`` runs n steps through the
    stage's ``run_steps`` (the captured graph) or, with ``eager``, through
    ``step_fn``; both return the loss of each step."""

    def __init__(self, flags, dev, eager=False):
        from qcpinn_tpu_torch import cli
        from qcpinn_tpu_torch.train.loop import train_stage

        args = cli.build_parser().parse_args(["train", *flags])
        cfg = cli.make_config(args)
        self.model = cli.make_model(cfg, dev)
        terms, operator, _, _ = cli.make_problem(args.problem, cfg)
        self.stage, _ = train_stage(self.model, cfg, terms, operator, dev,
                                    log=lambda msg: None)
        self.eager = eager

    @property
    def graph(self):
        return self.stage.run_steps.captured

    def steps(self, n):
        import torch

        if self.eager:
            return torch.stack([self.stage.step()["loss"] for _ in range(n)])
        return self.stage.run(n)["loss"]

    def step(self):
        return self.steps(1)[0]


def kernel_counters():
    """Every kernel's and plain version's launch counter of the package."""
    from qcpinn_tpu_torch.ops import block_kernel as bk, loop_kernel as lk, sv_kernel as sk

    return {f"{mod.__name__.rsplit('.', 1)[1]}.{k}": v
            for mod in (bk, lk, sk) for k, v in mod.LAUNCHES.items()}


def reset_kernel_counters():
    from qcpinn_tpu_torch.ops import block_kernel as bk, loop_kernel as lk, sv_kernel as sk

    for mod in (bk, lk, sk):
        mod.reset_launches()


def cli_train_phase(dev, smi):
    """Phase ``cli_train`` (docstring, 6d): each of CLI_RUNS through
    ``cli.main`` on the card, its step graphed against eager, its counters,
    metrics and checkpoint."""
    import torch

    from qcpinn_tpu_torch import bench, cli
    from qcpinn_tpu_torch.bridge import params_from_jax
    from qcpinn_tpu_torch.models.nn_core import count_trainable
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS, inject_balancer_params
    from qcpinn_tpu_torch.utils.checkpoint import load_checkpoint
    from qcpinn_tpu_torch.utils.evaluation import evaluate_relative_l2

    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "chip_smoke")
    os.makedirs(out_root, exist_ok=True)
    results = {}
    n_par = WARMUP_STEPS + 2  # the eager warm-ups, the capture, one replay
    for tag, flags, want_params in CLI_RUNS:
        # graph against eager over n_par steps; the eager ms a step is the
        # mean of the eager run's steps after the first
        ref, got = CliStepper(flags, dev, eager=True), CliStepper(flags, dev)
        l_ref = [float(take_steps(ref, 1)[0])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l_ref += take_steps(ref, n_par - 1).tolist()
        eager_ms = 1e3 * (time.perf_counter() - t0) / (n_par - 1)
        l_got = take_steps(got, n_par).tolist()
        row = graph_parity(f"cli_train {tag}", ref, got, l_ref, l_got)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(take_steps(got, GRAPH_TIME_STEPS)[-1])
        graph_ms = 1e3 * (time.perf_counter() - t0) / GRAPH_TIME_STEPS
        prof = bench.profile(got, graph_ms, steps=3, top=3)
        prof["top_device_ms_per_step"] = [[name[:60], ms] for name, ms
                                          in prof["top_device_ms_per_step"]]
        row.update({"eager_ms_per_step": eager_ms, "graph": prof})
        del ref, got
        torch.cuda.empty_cache()

        metrics_path = os.path.join(out_root, f"{tag}.json")
        argv = ["train", *flags, "--epochs", str(CLI_EPOCHS), "--print-every", "100",
                "--no-plots", "--output-dir", out_root, "--run-name", tag,
                "--metrics-json", metrics_path]
        reset_kernel_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise SystemExit(f"cli_train {tag}: exit code not 0")
        seconds = time.perf_counter() - t0
        counters = kernel_counters()
        if any(counters.values()):
            raise SystemExit(f"cli_train {tag}: kernels launched on this path: {counters}")
        with open(metrics_path) as f:
            m = json.load(f)
        values = [m["final_loss"], *m["metrics"].values()]
        if not all(math.isfinite(v) for v in values):
            raise SystemExit(f"cli_train {tag}: non-finite result {m}")
        if want_params is not None and m["trainable_params"] != want_params:
            raise SystemExit(f"cli_train {tag}: {m['trainable_params']} trainable "
                             f"parameters, the JAX record has {want_params}")

        # the checkpoint, reloaded into a fresh model, against the run's metrics
        args = cli.build_parser().parse_args(argv)
        cfg = cli.make_config(args)
        model = cli.make_model(cfg, dev)
        terms, operator, analytic_u, analytic_r = cli.make_problem(args.problem, cfg)
        inject_balancer_params(model, terms, cfg.loss_balancer)
        run_dir = max((d for d in os.listdir(out_root) if d.startswith(tag + "-")))
        ck = load_checkpoint(os.path.join(out_root, run_dir, "model"), model)
        model.load_state_dict(params_from_jax(ck["bundle"]["params"]))
        again = evaluate_relative_l2(
            model, analytic_u, analytic_r=analytic_r,
            operator=operator if analytic_r is not None else None,
            num=args.eval_grid, hi=[1.0, math.pi, math.pi] if args.problem == "navier_stokes"
            else None, dims=cli.IN_DIMS[args.problem], device=dev)
        if again != m["metrics"]:
            raise SystemExit(f"cli_train {tag}: reloaded checkpoint gives {again}, "
                             f"the run {m['metrics']}")
        results[tag] = {**row, "argv": argv, "seconds": seconds, "final_loss": m["final_loss"],
                        "metrics": m["metrics"], "trainable_params": m["trainable_params"],
                        "trainable_params_reloaded": count_trainable(model),
                        "checkpoint_reload": "rel-L2 bit-equal",
                        "kernel_counters": f"all {len(counters)} at 0"}
        del model
        torch.cuda.empty_cache()
    emit({"phase": "cli_train", "epochs": CLI_EPOCHS, "parity_steps": n_par,
          "tol": {"loss_rtol": 2e-5, "params": "2e-4*max(|ref|,1e-3)"}, "results": results,
          "card": smi})


def north_star_classical_phase(dev, smi):
    """Phase ``north_star_classical`` (docstring, 6e)."""
    from qcpinn_tpu_torch import north_star as ns

    args = ns.parse_args(["--solver", "classical", "--chunk", "25", "--total-steps", "100",
                          "--minutes", "1"])
    reset_kernel_counters()
    r = ns.run(args, device=dev)
    counters = kernel_counters()
    if any(counters.values()):
        raise SystemExit(f"north_star_classical: kernels launched: {counters}")
    if not (r["losses_finite"] and r["steps"] == 100
            and all(math.isfinite(r[k]) for k in ("rel_l2_u", "rel_l2_r"))):
        raise SystemExit(f"north_star_classical: {r}")
    emit({"phase": "north_star_classical", **r,
          "kernel_counters": f"all {len(counters)} at 0", "card": smi})


def cli_train_check():
    """``--cli-train``: the device phase's checks, then cli_train and
    north_star_classical alone (no kernel is built: the path runs none)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    dev = torch.device("cuda")
    cli_train_phase(dev, smi)
    north_star_classical_phase(dev, smi)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})


# -- the hardware-fidelity modes (phase hw_modes, --hw-modes) -----------------

HW_NOISE = dict(depolarizing=0.02, readout=0.01, per_gate=0.002)
# (tag, backend, n, B, forward limit, the kernels the engine launches): the
# main paths' value-row batches, each engine's own forward limit
HW_ENGINES = (
    ("block_kernel_12q", "block_kernel", 12, 2 * (1024 // 3), FWD_TOL,
     ("block_chain_fwd", "block_chain_bwd", "block_chain_reduce")),
    ("unrolled_8q", "unrolled", 8, 2 * (1024 // 3), 3e-5,
     ("unrolled_fwd_warp", "unrolled_bwd_warp", "unrolled_reduce")),
    ("unrolled_10q", "unrolled", 10, LOOP_BATCHES[1], 3e-5,
     ("unrolled_fwd_tile", "unrolled_bwd_tile", "unrolled_reduce")),
    ("loop_16q", "loop", 16, LOOP_BATCHES[1], LOOP_FWD_TOL,
     ("gate_loop_fwd", "gate_loop_bwd", "gate_loop_reduce")),
)
HW_SHOTS = 1024
LAW_DRAWS = 64
# the JAX records' commands (artifacts/spsa_ab_full.json, spsa_ab_split.json)
# and their rel-L2 of u; a run within a factor 2 of JAX's is in its band
HW_RECORDS = (
    ("spsa", "artifacts/spsa_ab_full.json"),
    ("spsa-split", "artifacts/spsa_ab_split.json"),
)
HW_SHORT_EPOCHS = 300
HW_CLI_MODES = (  # (tag, extra flags of the DV cascade 4q run)
    ("parameter-shift", ["--gradient-mode", "parameter-shift"]),
    ("spsa", ["--gradient-mode", "spsa"]),
    ("spsa-split", ["--gradient-mode", "spsa-split"]),
    ("parameter-shift_shots256", ["--gradient-mode", "parameter-shift", "--shots", "256"]),
    ("spsa_shots256", ["--gradient-mode", "spsa", "--shots", "256"]),
)
HW_SHOT_STEPS = 20  # steps of each sampled mode, graph against eager
HW_FLAGS = ["--problem", "diffusion", "--solver", "DV", "--ansatz", "cascade",
            "--num-qubits", "4", "--num-layers", "1", "--hidden-dim", "50",
            "--batch-size", "64", "--lr", "5e-3", "--seed", "7"]


def law(draws, z, shots):
    """(worst |mean - z| over 4 sigma / sqrt(D), the variance over sigma^2
    pooled over the elements) of D draws [D, ...] of each element, sigma^2 =
    (1 - z^2) / S; elements with |z| = 1 (sigma 0) left out."""
    d = draws.shape[0]
    sigma2 = (1.0 - z.double() ** 2) / shots
    keep = sigma2 > 1e-9
    mean_err = (draws.double().mean(0) - z.double()).abs() / (4.0 * sigma2.sqrt() / d**0.5)
    ratio = draws.double().var(0) / sigma2
    return float(mean_err[keep].max()), float(ratio[keep].mean()), int(keep.sum())


def hw_engine_rows(dev):
    """Each engine with a kernel at its main path's value-row shapes, under
    the noise channel (HW_NOISE) against the plain engine with the same
    channel: forward within the engine's limit, the gradients of sum(z * g)
    for params and inputs within 2e-4 * max|ref|, then a sampled readout of
    HW_SHOTS shots against the exact noisy <Z>: whole counts, the mean
    square error over sigma^2 within 10% of 1 (pooled over the B x n
    elements, one draw each), no element 10 sigma off. Every kernel of the engine launched, no plain
    version (the forward kernel in the sampled readout too); returns
    (rows, the counters of all the engines' runs)."""
    import torch

    from qcpinn_tpu_torch.ops import NoiseModel, make_fused_backend
    from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    gen = torch.Generator(device=dev).manual_seed(21)
    noise = NoiseModel(**HW_NOISE)
    rows, total = {}, {}
    for tag, backend, n, b, tol, names in HW_ENGINES:
        circ = DVCircuit(n, 1, "cross_mesh", seed=42)
        eng = make_fused_backend(circ, backend, device=dev)
        plain = BlockFusedCircuit(circ)
        p0 = 0.3 * torch.randn(circ.num_params, generator=gen, device=dev)
        x0 = torch.rand(b, n, generator=gen, device=dev) * math.pi
        g = torch.randn(b, n, generator=gen, device=dev)
        out = {}
        reset_kernel_counters()
        for which, e in (("kernel", eng), ("plain", plain)):
            p, x = p0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
            z = e.apply(p, x, noise=noise)
            gp, gx = torch.autograd.grad(torch.sum(z * g), (p, x))
            out[which] = (z.detach(), gp, gx)
            if which == "kernel":
                counters = kernel_counters()
        (z, gp, gx), (rz, rgp, rgx) = out["kernel"], out["plain"]
        fwd_err = (z - rz).abs().max().item()
        if not fwd_err <= tol:
            raise SystemExit(f"hw_modes {tag}: noisy forward err {fwd_err} > {tol}")
        bwd = {}
        for k, a, r in (("params", gp, rgp), ("inputs", gx, rgx)):
            e, scale = (a - r).abs().max().item(), r.abs().max().item()
            if not e <= BWD_RTOL * scale:
                raise SystemExit(f"hw_modes {tag}: noisy grad of {k} err {e} > "
                                 f"{BWD_RTOL} * {scale}")
            bwd[k] = e / scale
        reset_kernel_counters()
        with torch.no_grad():
            s = eng.apply(p0, x0, shots=HW_SHOTS, key=gen, noise=noise)
        sampled = kernel_counters()
        sigma = torch.sqrt((1.0 - z.double() ** 2) / HW_SHOTS)
        keep = sigma > 1e-6
        r = ((s.double() - z.double()) / sigma)[keep]
        ratio, worst = float((r**2).mean()), float(r.abs().max())
        counts = (1.0 - s) * HW_SHOTS / 2.0
        if not (torch.equal(counts, counts.round()) and 0.9 <= ratio <= 1.1
                and worst <= 10.0):
            raise SystemExit(f"hw_modes {tag}: sampled readout off its law: "
                             f"worst {worst} sigma, mean square {ratio} sigma^2")
        for c in (counters, sampled):
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        for k in names:
            key = next(c for c in counters if c.endswith("." + k))
            ref = PLAIN_NAME.get(k, f"{k}_ref")
            ref_key = next((c for c in counters if c.endswith("." + ref)), None)
            # the sampled readout is a forward alone: names[0]
            if counters[key] == 0 or (k == names[0] and sampled[key] == 0):
                raise SystemExit(f"hw_modes {tag}: {k} not launched")
            if ref_key and (counters[ref_key] or sampled[ref_key]):
                raise SystemExit(f"hw_modes {tag}: the plain version {ref} ran")
        rows[tag] = {
            "backend": backend, "n_qubits": n, "batch": b, "noise": HW_NOISE,
            "gate_counts": list(noise.bind(circ).gate_counts),
            "fwd_max_abs_err": fwd_err, "fwd_tol": tol,
            "bwd_max_err_over_scale": bwd, "bwd_tol": f"{BWD_RTOL}*max|ref|",
            "sampled": {"shots": HW_SHOTS, "elements": int(keep.sum()),
                        "worst_err_over_sigma": worst,
                        "mean_square_err_over_sigma2": ratio},
            "launches": {k: counters[next(c for c in counters if c.endswith("." + k))]
                         for k in names},
            "launches_sampled": {k: sampled[next(c for c in counters
                                                 if c.endswith("." + k))]
                                 for k in names}}
        del out, eng, plain, z, gp, gx, rz, rgp, rgx, s
        torch.cuda.empty_cache()
    return rows, total


def hw_sampled_z_graph(dev):
    """``measure.sampled_z`` in a captured step: LAW_DRAWS draws of every
    <Z_w> of an 8q cross_mesh state (B = 16) a replay, HW_SHOTS shots,
    from the generator the graph registers. Two replays, each by the law
    (every mean within 4 sigma / sqrt(D), the pooled variance within 25%),
    and different from each other."""
    import torch

    from qcpinn_tpu_torch.ops import measure
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS, CapturedStep

    n, b = SV_QUBITS, 16
    gen = torch.Generator(device=dev).manual_seed(5)
    circ = DVCircuit(n, 1, "cross_mesh", seed=42)
    p = 0.3 * torch.randn(circ.num_params, generator=gen, device=dev)
    x = torch.rand(b, n, generator=gen, device=dev) * math.pi
    with torch.no_grad():
        states = circ.state(p.reshape(circ.layers, -1), x).repeat(LAW_DRAWS, 1)
        z = measure.exact_z(states[:b], n)
    step = CapturedStep(
        lambda: measure.sampled_z(states, n, HW_SHOTS, gen).reshape(LAW_DRAWS, b, n), gen)
    draws = [step().clone() for _ in range(WARMUP_STEPS + 2)]
    if step.captured != 1 or step.replays != 2:
        raise SystemExit("hw_modes sampled_z: no replays")
    replays = draws[-2:]
    row = {"shots": HW_SHOTS, "draws_per_replay": LAW_DRAWS, "batch": b, "n_qubits": n,
           "replays": step.replays, "replays_differ": not torch.equal(*replays)}
    for i, r in enumerate(replays):
        worst, ratio, kept = law(r, z, HW_SHOTS)
        if not (worst <= 1.0 and abs(ratio - 1.0) <= 0.25):
            raise SystemExit(f"hw_modes sampled_z replay {i}: worst {worst}, ratio {ratio}")
        row[f"replay{i}"] = {"worst_mean_err_over_4sigma_sqrtD": worst,
                             "variance_over_sigma2": ratio, "elements": kept}
    if not row["replays_differ"]:
        raise SystemExit("hw_modes sampled_z: two replays drew the same samples")
    return row


def hw_parameter_shift(dev):
    """``make_hw_apply`` with shots=None against autograd through
    ``DVCircuit.apply``, on the card: DV cascade 4q and cross_mesh 8q (B =
    16, the noise channel on), params and inputs within atol 2e-4."""
    import torch

    from qcpinn_tpu_torch.ops import NoiseModel
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.train.hardware_grad import evals_per_step, make_hw_apply

    gen = torch.Generator(device=dev).manual_seed(9)
    noise = NoiseModel(**HW_NOISE)
    out = {}
    for ansatz, n in (("cascade", 4), ("cross_mesh", 8)):
        circ = DVCircuit(n, 1, ansatz, seed=42)
        p = (0.3 * torch.randn(1, circ.num_params, generator=gen, device=dev)).requires_grad_()
        x = (torch.rand(16, n, generator=gen, device=dev) * 2 - 1).requires_grad_()
        g = torch.randn(16, n, generator=gen, device=dev)
        hw = make_hw_apply(circ, None, noise=noise)
        got = torch.autograd.grad(torch.sum(hw(p, x) * g), (p, x))
        want = torch.autograd.grad(torch.sum(circ.apply(p, x, noise=noise) * g), (p, x))
        errs = [(a - r).abs().max().item() for a, r in zip(got, want)]
        if not max(errs) <= 2e-4:
            raise SystemExit(f"hw_modes parameter-shift {ansatz} {n}q: {errs} > 2e-4")
        out[f"{ansatz}_{n}q"] = {"params_max_abs_err": errs[0], "inputs_max_abs_err": errs[1],
                                 "tol": 2e-4, "evals_per_step": evals_per_step(circ)}
    return out


def hw_cli_modes(dev):
    """Each gradient mode's ``cli train`` step (DV cascade 4q, the JAX
    records' flags) graphed against eager from the same seed: with
    shots=None WARMUP_STEPS + 2 steps bit-equal (losses and parameters);
    with shots HW_SHOT_STEPS steps whose mean losses agree within 3
    standard errors. Then the graphed ms a step (10 replays) and a 3-step
    profile: launches, device time, idle share."""
    import torch

    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.train.loop import WARMUP_STEPS

    st = statistics
    out = {}
    for tag, flags in HW_CLI_MODES:
        sampled = "--shots" in flags
        n_steps = HW_SHOT_STEPS if sampled else WARMUP_STEPS + 2
        ref, got = CliStepper(HW_FLAGS + flags, dev, eager=True), CliStepper(HW_FLAGS + flags, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l_ref = take_steps(ref, n_steps).tolist()
        eager_ms = 1e3 * (time.perf_counter() - t0) / n_steps
        l_got = take_steps(got, n_steps).tolist()
        want = dict(ref.model.named_parameters())
        bit_equal = l_got == l_ref and all(torch.equal(p, want[k])
                                           for k, p in got.model.named_parameters())
        row = {"steps": n_steps, "bit_equal": bit_equal, "loss_first": l_got[0],
               "loss_last": l_got[-1], "eager_ms_per_step": eager_ms}
        if sampled:
            se = math.sqrt((st.pvariance(l_ref) + st.pvariance(l_got)) / n_steps)
            gap = abs(st.fmean(l_got) - st.fmean(l_ref))
            row.update({"mean_loss_graph": st.fmean(l_got), "mean_loss_eager": st.fmean(l_ref),
                        "mean_gap_over_se": gap / se if se > 0 else 0.0})
            if not (all(math.isfinite(v) for v in l_got) and gap <= 3.0 * se):
                raise SystemExit(f"hw_modes cli {tag}: graph mean {st.fmean(l_got)} against "
                                 f"eager {st.fmean(l_ref)} (se {se})")
        elif not bit_equal:
            raise SystemExit(f"hw_modes cli {tag}: graph not bit-equal to eager: "
                             f"{l_got} against {l_ref}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(take_steps(got, GRAPH_TIME_STEPS)[-1])
        graph_ms = 1e3 * (time.perf_counter() - t0) / GRAPH_TIME_STEPS
        prof = bench.profile(got, graph_ms, steps=3, top=3)
        prof["top_device_ms_per_step"] = [[name[:60], ms] for name, ms
                                          in prof["top_device_ms_per_step"]]
        row["graph"] = prof
        out[tag] = row
        del ref, got
        torch.cuda.empty_cache()
    return out


def record_jobs():
    """(mode, argv, record) of the JAX records' SPSA commands: each record's
    ``command`` with ``qcpinn_tpu_torch`` for ``qcpinn_tpu`` (the argv after
    the module) and its own --metrics-json and --output-dir left out."""
    import shlex

    here = os.path.dirname(os.path.abspath(__file__))
    jobs = []
    for mode, path in HW_RECORDS:
        with open(os.path.join(here, path)) as f:
            rec = json.load(f)
        argv = shlex.split(rec["command"])[3:]
        for flag in ("--metrics-json", "--output-dir"):
            i = argv.index(flag)
            del argv[i:i + 2]
        jobs.append((mode, argv, rec))
    return jobs


def hw_record_runs(dev, epochs, jobs, out_root):
    """``cli.main`` for each of ``jobs`` ((tag, argv, the JAX record or
    None)) at ``epochs`` epochs: wall time, final loss, rel-L2 of u and r
    (beside JAX's, with the ratio and whether it is within JAX's factor 2),
    every kernel counter 0 (the CLI's circuit runs gate by gate)."""
    import torch

    from qcpinn_tpu_torch import cli

    out = {}
    for tag, argv, rec in jobs:
        argv = list(argv)
        if "--epochs" in argv:
            argv[argv.index("--epochs") + 1] = str(epochs)
        else:
            argv += ["--epochs", str(epochs)]
        metrics_path = os.path.join(out_root, f"hw_{tag}.json")
        argv += ["--output-dir", out_root, "--run-name", f"hw_{tag}",
                 "--metrics-json", metrics_path]
        if "--no-plots" not in argv:
            argv.append("--no-plots")
        reset_kernel_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise SystemExit(f"hw_modes run {tag}: exit code not 0")
        seconds = time.perf_counter() - t0
        counters = kernel_counters()
        if any(counters.values()):
            raise SystemExit(f"hw_modes run {tag}: kernels launched: {counters}")
        with open(metrics_path) as f:
            m = json.load(f)
        if not all(math.isfinite(v) for v in [m["final_loss"], *m["metrics"].values()]):
            raise SystemExit(f"hw_modes run {tag}: non-finite result {m}")
        row = {"argv": argv, "epochs": epochs, "seconds": seconds,
               "final_loss": m["final_loss"], "metrics": m["metrics"],
               "trainable_params": m["trainable_params"]}
        if rec is not None:
            if m["trainable_params"] != rec["trainable_params"]:
                raise SystemExit(f"hw_modes run {tag}: {m['trainable_params']} trainable "
                                 f"parameters, the JAX record has {rec['trainable_params']}")
            u, ju = m["metrics"]["rel_l2_u_percent"], rec["metrics"]["rel_l2_u_percent"]
            row["jax"] = {"epochs": rec["config"]["epochs"], "final_loss": rec["final_loss"],
                          "metrics": rec["metrics"]}
            row["u_over_jax"] = u / ju
            row["in_band"] = 0.5 * ju <= u <= 2.0 * ju
        out[tag] = row
    return out


def hw_modes_phase(dev, smi):
    """Phase ``hw_modes``: the noisy and sampled readouts through each
    engine with a kernel (``hw_engine_rows``), ``sampled_z`` over replays of
    a captured step, parameter-shift against autograd, each gradient mode's
    ``cli train`` step graphed against eager, and short runs of the JAX
    records' SPSA commands. Returns the kernels' launch counters of the
    engine checks."""
    import torch

    rows, launches = hw_engine_rows(dev)
    torch.cuda.empty_cache()
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "chip_smoke")
    os.makedirs(out_root, exist_ok=True)
    emit({"phase": "hw_modes", "noise": HW_NOISE, "engines": rows,
          "sampled_z_graph": hw_sampled_z_graph(dev),
          "parameter_shift": hw_parameter_shift(dev),
          "cli_modes": hw_cli_modes(dev),
          "records_short": hw_record_runs(dev, HW_SHORT_EPOCHS, record_jobs(), out_root),
          "card": smi})
    return launches


def hw_modes_check():
    """``--hw-modes``: the device phase's checks, then the JAX records' two
    SPSA commands at their 3000 epochs and a parameter-shift run at --shots
    1024 for 500 epochs (no kernel is built: the CLI path runs none)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    dev = torch.device("cuda")
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "chip_smoke")
    os.makedirs(out_root, exist_ok=True)
    emit({"phase": "hw_records", "card": smi,
          "results": hw_record_runs(dev, 3000, record_jobs(), out_root)})
    ps = ("parameter-shift_shots1024", ["train", *HW_FLAGS, "--gradient-mode",
                                        "parameter-shift", "--shots", "1024",
                                        "--print-every", "100"], None)
    emit({"phase": "hw_parameter_shift_run", "card": smi,
          "results": hw_record_runs(dev, 500, [ps], out_root)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})


# -- the Czochralski flagship (phase cz, --cz-phase, --cz) -----------------------

CZ_DATA = "data/cz_melt_raw.txt"
# (checkpoint, its flags) of the eval checks; the default run takes the
# first two, --cz all six of JAX's Cz checkpoints
CZ_EVALS = (
    ("artifacts/cz_real_wide384_400", ["--trunk-width", "384"]),
    ("artifacts/cz_real_balanced", []),
    ("artifacts/cz_real_wide384", ["--trunk-width", "384"]),
    ("artifacts/cz_real_finetune", []),
    ("artifacts/cz_real_finetune_full", []),
    ("artifacts/cz_real_wide384_400_ft_noise", ["--trunk-width", "384"]),
)
CZ_FIELD_RTOL = 0.01  # each field's rel-L2 against JAX's
CZ_MSE_RTOL = 0.02  # val_mse against JAX's
# JAX's own evaluation of each checkpoint on the CPU (the JAX package's
# evaluate_cz_fields on data/cz_melt_raw.txt with the checkpoint's stats;
# tests/test_torch_cz_records.py recomputes it, pytest -m slow). The
# artifacts' *_eval.json records were taken on the TPU, whose default
# precision rounds the inputs of the Fourier projection (nn_core.py's
# fourier_features_apply: a jnp.dot without precision=HIGHEST) to bf16, so
# they are 1.1-2.3x below these; the port, like JAX on the CPU, projects in
# f32. The port is held to these.
CZ_JAX_CPU_EVAL = {
    "artifacts/cz_real_wide384_400": {
        "val_mse": 1.9449623778200475e-06, "rel_l2_u_r_percent": 8.21337718503944,
        "rel_l2_u_z_percent": 2.3559215367612865, "rel_l2_u_theta_percent": 12.147654268516199,
        "rel_l2_p_percent": 0.1512547097355727, "rel_l2_T_percent": 0.21459041423402955},
    "artifacts/cz_real_balanced": {
        "val_mse": 2.976521045638947e-06, "rel_l2_u_r_percent": 16.17667754829257,
        "rel_l2_u_z_percent": 2.8433419920270464, "rel_l2_u_theta_percent": 22.390440401727826,
        "rel_l2_p_percent": 0.19016388283147126, "rel_l2_T_percent": 0.2672229193960725},
    "artifacts/cz_real_wide384": {
        "val_mse": 2.091814167215489e-06, "rel_l2_u_r_percent": 9.369381494069826,
        "rel_l2_u_z_percent": 2.5075968642115734, "rel_l2_u_theta_percent": 14.54402940293444,
        "rel_l2_p_percent": 0.14717287491873557, "rel_l2_T_percent": 0.19742111794489509},
    "artifacts/cz_real_finetune": {
        "val_mse": 3.636244400695432e-06, "rel_l2_u_r_percent": 19.292691882127922,
        "rel_l2_u_z_percent": 3.0434350440914995, "rel_l2_u_theta_percent": 30.516238238720867,
        "rel_l2_p_percent": 0.22495521446682867, "rel_l2_T_percent": 0.305993073314344},
    "artifacts/cz_real_finetune_full": {
        "val_mse": 8.48624677018961e-06, "rel_l2_u_r_percent": 22.209790367073772,
        "rel_l2_u_z_percent": 3.776677741292878, "rel_l2_u_theta_percent": 75.53609456114079,
        "rel_l2_p_percent": 0.47666401247462176, "rel_l2_T_percent": 0.5569283491133427},
    "artifacts/cz_real_wide384_400_ft_noise": {
        "val_mse": 2.107660520778154e-06, "rel_l2_u_r_percent": 10.134801057862287,
        "rel_l2_u_z_percent": 2.4105494200414013, "rel_l2_u_theta_percent": 14.749899344842035,
        "rel_l2_p_percent": 0.16456859621660488, "rel_l2_T_percent": 0.229083839037599},
}
CZ_CKPT = "artifacts/cz_real_wide384_400"  # the steps' starting point
CZ_QUBITS, CZ_WIDTH = 16, 384  # its circuit and trunk
# the wide384_400 record's pretrain command: 16 qubits, 2 layers, trunk 384,
# B = 256, balanced, warmup 25, ramp 60, 400 epochs; epoch 100 has the
# physics fully engaged
CZ_PRETRAIN = dict(epochs=400, batch_size=256, physics_weight=0.05, physics_warmup=25,
                   physics_ramp=60, physics_normalize="balanced", seed=42)
CZ_EPOCH = 100
CZ_STEPS = 5  # graph against eager: 3 eager warm-ups, the capture, a replay
# the ft_noise record's finetune (artifacts/cz_real_wide384_400_ft_noise.json)
CZ_FINETUNE = dict(shots=4096, calib_size=8, noise_readout=0.01, noise_per_gate=0.001,
                   seed=42)
CZ_FT_STEPS = 10  # sampled steps, graph against eager: means within 3 se
# the JAX records' finetune commands (--cz) and the pretrain record timed
CZ_FT_RECORDS = ("artifacts/cz_real_finetune", "artifacts/cz_real_finetune_full",
                 "artifacts/cz_real_wide384_400_ft_noise")
CZ_PRETRAIN_RECORD = "artifacts/cz_real_balanced"
CZ_PRETRAIN_MINUTES = 20


def cz_cli(argv):
    """``cli.main(argv)`` on the card with its standard output captured;
    (exit code, the output, seconds)."""
    import contextlib
    import io

    import torch

    from qcpinn_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def cz_eval(ckpt, flags, out_root):
    """``cz --phase eval`` of ``ckpt`` on the real melt data: the metrics
    against JAX's own evaluation of the checkpoint (CZ_JAX_CPU_EVAL: each
    field's rel-L2 within 1% relative, val_mse within 2%) and, for the
    record, against the checkpoint's TPU eval record; the kernel counters 0
    (no kernel of the package is on the Cz path)."""
    reset_kernel_counters()
    rc, text, seconds = cz_cli(["cz", "--phase", "eval", "--data", CZ_DATA, "--load", ckpt,
                                *flags, "--no-plots", "--output-dir", out_root])
    counters = kernel_counters()
    if rc != 0 or any(counters.values()):
        raise SystemExit(f"cz eval {ckpt}: exit code {rc}, kernel counters {counters}")
    metrics = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    jax_cpu = CZ_JAX_CPU_EVAL[ckpt]
    ratio = {k: metrics[k] / jax_cpu[k] for k in jax_cpu}
    ok = all(abs(r - 1.0) <= (CZ_MSE_RTOL if k == "val_mse" else CZ_FIELD_RTOL)
             for k, r in ratio.items())
    row = {"checkpoint": ckpt, "seconds": seconds, "metrics": metrics,
           "over_jax_cpu": ratio, "within_tolerance": ok}
    if os.path.exists(ckpt + "_eval.json"):
        with open(ckpt + "_eval.json") as f:
            record = json.load(f)
        row["tpu_record_over_jax_cpu"] = {k: record[k] / jax_cpu[k] for k in record}
    return row


def cz_tree(ckpt):
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from qcpinn_tpu_torch.utils.checkpoint import load_checkpoint

    return load_checkpoint(ckpt, Hybrid16QPINN(CZ_QUBITS, 2, width=CZ_WIDTH, device="cpu"))


def cz_pretrain_epoch(dev, tree, X, Y, stats, batch, remat):
    """A PretrainEpoch of the wide384_400 command on a model loaded with
    ``tree``, its lr and physics weight those of epoch CZ_EPOCH."""
    from qcpinn_tpu_torch.bridge import params_from_jax
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from qcpinn_tpu_torch.train import cz_pipeline as cp

    model = Hybrid16QPINN(CZ_QUBITS, 2, remat=remat, width=CZ_WIDTH, seed=42, device=dev)
    model.load_state_dict(params_from_jax(tree))
    cfg = cp.CzConfig(**{**CZ_PRETRAIN, "n_qubits": CZ_QUBITS, "batch_size": batch,
                         "remat": remat})
    ep = cp.make_pretrain_epoch(model, X, Y, stats, cfg)
    ep.phys_w.fill_(cp._phys_weight(cfg, CZ_EPOCH))
    ep.lr.fill_(cp._cosine_lr(cfg.lr, CZ_EPOCH, cfg.epochs))
    return model, ep


class _Stepper:
    """``step()`` for ``bench.profile``."""

    def __init__(self, fn):
        self.step = fn


def cz_pretrain(dev):
    """The pretrain step at the wide384_400 record's command: the graphed
    step against the eager one, CZ_STEPS steps on the same batches (losses,
    parameters and the EMA state bit-equal); ms a step eager (after its
    first step) and graphed, a 3-step profile of the graphed step
    (launches, device ms, idle share), the peak memory of each; then the
    peak memory at B = 512 with remat (its forward-mode residual in chunks
    of 256 rows)."""
    import torch

    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.data.cz_loader import DataStats, load_cz_data

    restored = cz_tree(CZ_CKPT)
    stats = DataStats.from_dict(restored["stats"])
    X, Y, _ = load_cz_data(CZ_DATA, stats)
    tree = restored["bundle"]["params"]
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(len(X), generator=gen, device=dev)
    Xd, Yd = torch.as_tensor(X, device=dev)[perm], torch.as_tensor(Y, device=dev)[perm]
    b = CZ_PRETRAIN["batch_size"]

    def steps(ep, n, start=0):
        out = []
        for i in range(start, start + n):
            ep.xb.copy_(Xd[i * b:(i + 1) * b])
            ep.yb.copy_(Yd[i * b:(i + 1) * b])
            out.append(ep._step().clone())  # a replay's output is the graph's static tensor
        return torch.stack(out)

    row = {"batch": b, "width": CZ_WIDTH, "n_qubits": CZ_QUBITS, "epoch": CZ_EPOCH}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref_model, ref = cz_pretrain_epoch(dev, tree, X, Y, stats, b, False)
    ref._step = ref.static_step  # the eager plain version
    l_ref = [steps(ref, 1)]  # the first step builds cuBLAS's handles and plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_ref.append(steps(ref, CZ_STEPS - 1, 1))
    torch.cuda.synchronize()
    row["eager_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / (CZ_STEPS - 1)
    l_ref = torch.cat(l_ref)
    row["eager_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got_model, got = cz_pretrain_epoch(dev, tree, X, Y, stats, b, False)
    l_got = steps(got, CZ_STEPS)
    torch.cuda.synchronize()
    row["graph_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    want = dict(ref_model.named_parameters())
    bit_equal = (torch.equal(l_got, l_ref)
                 and all(torch.equal(p, want[k]) for k, p in got_model.named_parameters())
                 and all(torch.equal(got.ema[k], ref.ema[k]) for k in ref.ema))
    row.update({"parity_steps": CZ_STEPS, "bit_equal": bit_equal,
                "loss_first": float(l_got[0, 0]), "loss_last": float(l_got[-1, 0]),
                "data_last": float(l_got[-1, 1]), "phys_last": float(l_got[-1, 2]),
                "eager_steps": got.captured.eager_steps, "captured": got.captured.captured})
    if not bit_equal:
        raise SystemExit(f"cz pretrain: graph not bit-equal to eager: {l_got.tolist()} "
                         f"against {l_ref.tolist()}")
    if not torch.isfinite(l_got).all():
        raise SystemExit(f"cz pretrain: non-finite losses {l_got.tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(got, GRAPH_TIME_STEPS, CZ_STEPS)
    torch.cuda.synchronize()
    row["graph_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / GRAPH_TIME_STEPS
    row["graph"] = bench.profile(_Stepper(lambda: steps(got, 1, CZ_STEPS)),
                                 row["graph_ms_per_step"], steps=3, top=6)
    row["epoch_s_at_graph_rate"] = row["graph_ms_per_step"] * (len(X) // b) / 1e3
    del ref, got, ref_model, got_model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _, ep512 = cz_pretrain_epoch(dev, tree, X, Y, stats, 2 * b, True)
    ep512._step = ep512.static_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l512 = torch.stack([ep512.step_fn(Xd[i * 2 * b:(i + 1) * 2 * b], Yd[i * 2 * b:(i + 1) * 2 * b],
                                      ep512.phys_w, ep512.lr) for i in range(2)])
    torch.cuda.synchronize()
    row["remat_512"] = {"batch": 2 * b, "chunk_rows": ep512.chunk_rows,
                        "eager_ms_per_step": 1e3 * (time.perf_counter() - t0) / 2,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "losses": l512[:, 0].tolist()}
    if not torch.isfinite(l512).all():
        raise SystemExit(f"cz pretrain B=512: non-finite losses {l512.tolist()}")
    del ep512
    torch.cuda.empty_cache()
    return row


def cz_finetune(dev):
    """Head- and full-scope finetune steps from the wide384_400 checkpoint
    with the ft_noise record's shots, calibration size and noise: the
    graphed step (its generator registered) against the eager one from the
    same seed over CZ_FT_STEPS sampled steps (means within 3 standard
    errors), ms a step, a 3-step profile, the circuit evaluations a step
    and the leaves that moved."""
    import torch

    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.bridge import params_from_jax
    from qcpinn_tpu_torch.data.cz_loader import DataStats, load_cz_data
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from qcpinn_tpu_torch.train import cz_pipeline as cp
    from qcpinn_tpu_torch.train.hardware_grad import evals_per_step_cz

    restored = cz_tree(CZ_CKPT)
    X, Y, _ = load_cz_data(CZ_DATA, DataStats.from_dict(restored["stats"]))
    tree = restored["bundle"]["params"]
    st = statistics
    out = {}
    for scope in ("head", "full"):
        cfg = cp.CzConfig(**CZ_FINETUNE, n_qubits=CZ_QUBITS, train_scope=scope)
        pair = []
        for _ in range(2):
            model = Hybrid16QPINN(CZ_QUBITS, 2, width=CZ_WIDTH, seed=42, device=dev)
            model.load_state_dict(params_from_jax(tree))
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
            pair.append((model, cp.FinetuneStep(model, X, Y, cfg, gen)))
        (ref_model, ref), (got_model, got) = pair
        before = {k: p.detach().clone() for k, p in got_model.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l_ref = [float(ref.step()) for _ in range(CZ_FT_STEPS)]
        eager_ms = 1e3 * (time.perf_counter() - t0) / CZ_FT_STEPS
        l_got = [float(got.run()) for _ in range(CZ_FT_STEPS)]
        se = math.sqrt((st.pvariance(l_ref) + st.pvariance(l_got)) / CZ_FT_STEPS)
        gap = abs(st.fmean(l_got) - st.fmean(l_ref))
        if not (all(math.isfinite(v) for v in l_got) and gap <= 3.0 * se):
            raise SystemExit(f"cz finetune {scope}: graph mean {st.fmean(l_got)} against "
                             f"eager {st.fmean(l_ref)} (se {se})")
        moved = sorted({k.split(".")[0] for k, p in got_model.named_parameters()
                        if not torch.equal(p, before[k])})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIME_STEPS):
            got.run()
        torch.cuda.synchronize()
        graph_ms = 1e3 * (time.perf_counter() - t0) / GRAPH_TIME_STEPS
        out[scope] = {
            "steps": CZ_FT_STEPS, "bit_equal": l_got == l_ref, "mean_loss_graph": st.fmean(l_got),
            "mean_loss_eager": st.fmean(l_ref), "mean_gap_over_se": gap / se if se else 0.0,
            "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
            "graph": bench.profile(_Stepper(got.run), graph_ms, steps=3, top=6),
            "circuit_evals_per_step": (evals_per_step_cz(got_model.qlayer)
                                       if scope == "full" else 1),
            "leaves_moved": moved}
        del pair, ref, got, ref_model, got_model
        torch.cuda.empty_cache()
    if out["head"]["leaves_moved"] != ["post"] or "q" not in out["full"]["leaves_moved"]:
        raise SystemExit(f"cz finetune: moved {out['head']['leaves_moved']} (head), "
                         f"{out['full']['leaves_moved']} (full)")
    return out


def cz_phase(dev, smi):
    """Phase ``cz``: ``cz --phase eval`` of the two records' checkpoints,
    the pretrain step and the finetune steps; every kernel counter 0."""
    import torch

    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "chip_smoke")
    os.makedirs(out_root, exist_ok=True)
    t0 = time.perf_counter()
    evals = [cz_eval(ck, flags, out_root) for ck, flags in CZ_EVALS[:2]]
    bad = [r for r in evals if not r["within_tolerance"]]
    if bad:
        emit({"phase": "cz_eval_failed", "results": bad})
        raise SystemExit("cz: eval outside its record's tolerance")
    t_eval = time.perf_counter() - t0
    reset_kernel_counters()
    pretrain = cz_pretrain(dev)
    t_pre = time.perf_counter() - t0 - t_eval
    finetune = cz_finetune(dev)
    counters = kernel_counters()
    if any(counters.values()):
        raise SystemExit(f"cz: kernels launched on this path: {counters}")
    torch.cuda.empty_cache()
    emit({"phase": "cz", "eval": evals, "pretrain": pretrain, "finetune": finetune,
          "seconds": {"eval": t_eval, "pretrain": t_pre,
                      "finetune": time.perf_counter() - t0 - t_eval - t_pre},
          "tol": {"fields_rel": CZ_FIELD_RTOL, "val_mse_rel": CZ_MSE_RTOL},
          "kernel_counters": f"all {len(counters)} at 0", "card": smi})


def cz_record_finetune(path, out_root):
    """The record's finetune command (its flags from the record's config,
    --no-plots, our own --save), then eval of the result: against the
    record's eval (each metric within JAX's factor 2) and its loss history
    (each epoch's loss within a factor 2 of the record's); the eval also
    against JAX's own evaluation of the record's checkpoint (its factor 2)."""
    with open(path + ".json") as f:
        rec = json.load(f)
    c = rec["config"]
    save = os.path.join(out_root, os.path.basename(path))
    flags = ["--trunk-width", str(c.get("trunk_width") or 128)]
    argv = ["cz", "--phase", "finetune", "--data", CZ_DATA, "--load", c["load"],
            "--save", save, "--epochs", str(c["epochs"]), "--shots", str(c["shots"]),
            "--calib-size", str(c["calib_size"]), "--train-scope", c["train_scope"],
            "--noise-depolarizing", str(c["noise_depolarizing"] or 0.0),
            "--noise-readout", str(c["noise_readout"] or 0.0),
            "--noise-per-gate", str(c.get("noise_per_gate") or 0.0),
            "--seed", str(c["seed"]), "--log-every", str(c["log_every"]),
            "--no-plots", "--output-dir", out_root, *flags]
    rc, _, seconds = cz_cli(argv)
    if rc != 0:
        raise SystemExit(f"cz finetune {path}: exit code {rc}")
    with open(save + ".json") as f:
        hist = json.load(f)["loss_history"]
    want = rec["loss_history"]
    ratios = [a / b for a, b in zip(hist, want)]
    row = {"record": path, "argv": argv, "seconds": seconds, "epochs": len(hist),
           "loss_first": hist[0], "loss_last": hist[-1],
           "record_loss_first": want[0], "record_loss_last": want[-1],
           "epochs_within_factor_2": sum(0.5 <= r <= 2.0 for r in ratios),
           "loss_over_record_min_max": [min(ratios), max(ratios)]}
    rc, text, eval_s = cz_cli(["cz", "--phase", "eval", "--data", CZ_DATA, "--load", save,
                               *flags, "--no-plots", "--output-dir", out_root])
    metrics = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    row["eval"] = metrics
    jax_cpu = CZ_JAX_CPU_EVAL[path]
    row["eval_over_jax_cpu"] = {k: metrics[k] / jax_cpu[k] for k in jax_cpu}
    row["eval_in_jax_cpu_band"] = all(0.5 <= r <= 2.0 for r in row["eval_over_jax_cpu"].values())
    if os.path.exists(path + "_eval.json"):
        with open(path + "_eval.json") as f:
            record = json.load(f)
        row["record_eval"] = record
        row["eval_over_record"] = {k: metrics[k] / record[k] for k in record}
        row["eval_in_band"] = all(0.5 <= r <= 2.0 for r in row["eval_over_record"].values())
    return row


def cz_record_pretrain(out_root):
    """The cz_real_balanced record's pretrain command under --time-budget
    CZ_PRETRAIN_MINUTES: the epochs reached, s an epoch, and the loss at each
    logged epoch against the record's history (within a factor 2 after
    epoch 1)."""
    with open(CZ_PRETRAIN_RECORD + ".json") as f:
        rec = json.load(f)
    c = rec["config"]
    save = os.path.join(out_root, "cz_real_balanced_port")
    argv = ["cz", "--phase", "pretrain", "--data", CZ_DATA, "--save", save,
            "--epochs", str(c["epochs"]), "--batch-size", str(c["batch_size"]),
            "--lr", str(c["lr"]), "--physics-weight", str(c["physics_weight"]),
            "--physics-warmup", str(c["physics_warmup"]),
            "--physics-ramp", str(c["physics_ramp"]), "--physics-normalize",
            c["physics_normalize"], "--seed", str(c["seed"]), "--log-every",
            str(c["log_every"]), "--time-budget", str(CZ_PRETRAIN_MINUTES),
            "--no-plots", "--output-dir", out_root]
    rc, text, seconds = cz_cli(argv)
    if rc != 0:
        raise SystemExit(f"cz pretrain record: exit code {rc}")
    with open(save + ".json") as f:
        hist = json.load(f)["loss_history"]
    want = rec["loss_history"]
    logged = [e for e in range(1, len(hist) + 1) if e == 1 or e % c["log_every"] == 0]
    by_epoch = {e: [hist[e - 1], want[e - 1], hist[e - 1] / want[e - 1]] for e in logged}
    elapsed = [float(m) for m in re.findall(r"elapsed=([0-9.]+)s", text)]
    return {"argv": argv, "seconds": seconds, "epochs_reached": len(hist),
            "s_per_epoch": seconds / len(hist), "log_elapsed_s": elapsed[-1] if elapsed else None,
            "loss_port_record_ratio_by_logged_epoch": by_epoch,
            "in_band_after_epoch_1": all(0.5 <= r <= 2.0 for e, (_, _, r) in by_epoch.items()
                                         if e > 1)}


def cz_device():
    """The device phase's checks for the cz modes; (device, smi line)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)

    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return torch.device("cuda"), smi


def cz_phase_check():
    """``--cz-phase``: the device phase's checks, then the cz phase alone
    (no kernel is built: the Cz path runs none)."""
    t_start = time.perf_counter()
    dev, smi = cz_device()
    cz_phase(dev, smi)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})


def cz_check():
    """``--cz``: JAX's Cz records on the card. The eval of every checkpoint
    with an eval record, the three finetune records' commands and their
    evals, and the cz_real_balanced pretrain command under a time budget."""
    t_start = time.perf_counter()
    dev, smi = cz_device()
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "chip_smoke")
    os.makedirs(out_root, exist_ok=True)
    emit({"phase": "cz_record_evals", "card": smi,
          "results": [cz_eval(ck, flags, out_root) for ck, flags in CZ_EVALS]})
    emit({"phase": "cz_record_finetunes", "card": smi,
          "results": [cz_record_finetune(p, out_root) for p in CZ_FT_RECORDS]})
    emit({"phase": "cz_record_pretrain", "card": smi,
          "minutes": CZ_PRETRAIN_MINUTES, "result": cz_record_pretrain(out_root)})
    del dev
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})


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


def step_cost_programs(sk, n, steps, rows):
    """MicroPrograms of ``n`` qubits, one per entry of ``rows`` (name: its
    Step list), each with one Haar 4x4 and as many phase rows as its diags
    name; returns (programs, the 4x4)."""
    import numpy as np

    u = np.linalg.qr(np.random.default_rng(0).normal(size=(4, 4, 2)).view(np.complex128)[..., 0])[0]
    programs = {name: sk.MicroProgram(
        n, tuple(r), sum(st.kind in ("1q", "c1q") for st in r),
        max([st.phase + 1 for st in r if st.kind == "diag"], default=1),
        (u.astype(np.complex64),)) for name, r in rows.items()}
    return programs, u


def step_cost_rows(sk, programs, u, eng, b, gen, dev, routes):
    """Graph ms of each program's launches at batch ``b`` on random inputs:
    ``routes`` maps a column name to a function (mp, states, banks) -> one
    launch."""
    import torch

    n = eng.circuit.n
    x = torch.randn(4, b, 1 << n, generator=gen, device=dev)
    states = tuple(x[i].contiguous() for i in range(4))
    u4 = torch.view_as_real(torch.tensor(u, dtype=torch.complex64)).reshape(1, 32).to(dev)
    rows = {}
    for name, mp in programs.items():
        k, p = max(mp.num_mats, 1), max(mp.num_phases, 1)
        m = torch.linalg.qr(torch.randn(b, k, 2, 2, dtype=torch.complex64, device=dev))[0]
        phi = torch.rand(p, 1 << n, generator=gen, device=dev)
        banks = (m.real.contiguous(), m.imag.contiguous(), torch.cos(phi), torch.sin(phi),
                 eng.constants(dev).u4 if name.startswith("program") else u4)
        rows[name] = {"steps": len(mp.steps), "segments": len(sk.segments(mp)),
                      **{col: graph_ms(lambda: fn(mp, states, banks))
                         for col, fn in routes.items()}}
    return rows


def unrolled_step_costs():
    """``--unrolled-step-costs``: the warp routes (K4, K3) at 8 qubits and
    the tile routes (K4, K3) at 10 qubits, per step kind and per segment,
    on 29-step tables of one step kind each. At 8q (both main batches):
    mats on a lane bit and on a register bit (controlled too), diag, u2q on
    two lane bits, on a lane and a register bit and on two register bits,
    then the 8q program and a one-step table (the launch, loads and
    stores); the warp route's ms a step over the one-step table. At 10q,
    B = 425 (north_star_plain's value batch): mats on three bits (one
    segment), mats cycling over all ten bits (a segment every three steps),
    controlled mats, diags, u2qs on three bits (one segment), u2qs on
    disjoint pairs (a segment each), the 10q program and a one-step table;
    the tile route's ms a step (the one-segment tables over the one-step
    table) and ms a segment (the ten-bit mats over the three-bit mats, per
    extra segment). One JSON line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from qcpinn_tpu_torch.ops import sv_kernel as sk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    steps, S = 29, sk.Step

    # -- 8q: the warp routes; wire w is bit n-1-w, wires 0-4 the lane bits
    n = SV_QUBITS
    programs, u = step_cost_programs(sk, n, steps, {
        "mat_lane": [S("1q", wire=g % 5, mat=g) for g in range(steps)],
        "mat_reg": [S("1q", wire=5 + g % 3, mat=g) for g in range(steps)],
        "mat_lane_ctrl": [S("c1q", ctrl=5 + g % 3, wire=g % 5, mat=g) for g in range(steps)],
        "diag": [S("diag", phase=g % 2) for g in range(steps)],
        "u2q_lanes": [S("u2q", ctrl=g % 5, wire=(g + 1) % 5, u4=0) for g in range(steps)],
        "u2q_lane_reg": [S("u2q", ctrl=g % 5, wire=5 + g % 3, u4=0) for g in range(steps)],
        "u2q_regs": [S("u2q", ctrl=5 + g % 3, wire=5 + (g + 1) % 3, u4=0)
                     for g in range(steps)],
        "one_step": [S("diag", phase=0)],
    })
    eng = sk.FusedCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
    programs["program_8q"] = eng.mp_evolve
    warp = {
        "warp_graph_ms": lambda mp, st, bk: sk.unrolled_bwd_warp_partials(*st, *bk, mp),
        "warp_fwd_graph_ms": lambda mp, st, bk: sk.unrolled_fwd_warp(*st[:2], *bk, mp),
    }
    out = {}
    for b, _ in SV_BATCHES:
        rows = step_cost_rows(sk, programs, u, eng, b, gen, dev, warp)
        for col in warp:
            fixed = rows["one_step"][col]
            for r in rows.values():
                if r["steps"] > 1:
                    r[col.replace("graph_ms", "ms_per_step")] = (
                        (r[col] - fixed) / (r["steps"] - 1))
        out[str(b)] = rows
    mp8 = programs["program_8q"]
    warps, smem, grid, ctas = sk.warp_config(dev, n, mp8.num_mats, mp8.num_phases,
                                             len(mp8.u4s), SV_BATCHES[0][0])

    # -- 10q: the tile routes
    n, b = SV_TILE_QUBITS, SV_TILE_BATCHES[1][0]
    programs, u = step_cost_programs(sk, n, steps, {
        "mat_3bits": [S("1q", wire=g % 3, mat=g) for g in range(steps)],
        "mat_10bits": [S("1q", wire=g % 10, mat=g) for g in range(steps)],
        "mat_ctrl_3bits": [S("c1q", ctrl=5 + g % 5, wire=g % 3, mat=g) for g in range(steps)],
        "diag": [S("diag", phase=g % 2) for g in range(steps)],
        "u2q_3bits": [S("u2q", ctrl=g % 3, wire=(g + 1) % 3, u4=0) for g in range(steps)],
        "u2q_pairs": [S("u2q", ctrl=(2 * g) % 10, wire=(2 * g + 1) % 10, u4=0)
                      for g in range(steps)],
        "one_step": [S("diag", phase=0)],
    })
    eng = sk.FusedCircuit(DVCircuit(n, 1, "cross_mesh", seed=42))
    programs["program_10q"] = eng.mp_evolve
    tile = {
        "tile_graph_ms": lambda mp, st, bk: sk.unrolled_bwd_cta_partials(*st, *bk, mp),
        "tile_fwd_graph_ms": lambda mp, st, bk: sk.unrolled_fwd_tile(*st[:2], *bk, mp),
    }
    rows = step_cost_rows(sk, programs, u, eng, b, gen, dev, tile)
    for col in tile:
        fixed = rows["one_step"][col]
        for name in ("mat_3bits", "mat_ctrl_3bits", "diag", "u2q_3bits"):
            rows[name][col.replace("graph_ms", "ms_per_step")] = (
                (rows[name][col] - fixed) / (steps - 1))
        extra = rows["mat_10bits"]["segments"] - rows["mat_3bits"]["segments"]
        rows["mat_10bits"][col.replace("graph_ms", "ms_per_segment")] = (
            (rows["mat_10bits"][col] - rows["mat_3bits"][col]) / extra)
    mp10 = programs["program_10q"]
    cfg = sk.tile_config(dev, mp10, mp10.num_mats, mp10.num_phases, len(mp10.u4s), b, True)
    # the phase rows staged in shared memory, or read at each diag step
    # (SMEM_MAX set just under the staged layout's size, so tile_config
    # takes the __ldg variant), at the 10q main path's shapes
    staging = {}
    limit = sk.SMEM_MAX
    circ = DVCircuit(n, 1, "cross_mesh", seed=42)
    for bb, mode in SV_TILE_BATCHES:
        mp, _, _, banks, (xr, xi, gr, gi) = sv_inputs(sk, circ, bb, mode, gen, dev)
        y = sk.unrolled_fwd(xr, xi, *banks, mp)
        k, p, u = banks[0].shape[1], banks[2].shape[0], banks[4].shape[0]
        fwd = lambda: sk.unrolled_fwd_tile(xr, xi, *banks, mp)  # noqa: E731
        bwd = lambda: sk.unrolled_bwd_cta_partials(*y, gr, gi, *banks, mp)  # noqa: E731
        for tag, staged in (("rows_staged", True), ("rows_ldg", False)):
            row = staging[f"{bb}_{tag}"] = {}
            for key, is_bwd, fn in (("fwd_graph_ms", False, fwd), ("bwd_graph_ms", True, bwd)):
                full = sk.tile_smem(n, k, p, u, len(sk.segments(mp)), len(mp.steps), is_bwd,
                                    True, is_bwd)
                sk.SMEM_MAX = full if staged else full - 4
                row[key] = graph_ms(fn)
            sk.SMEM_MAX = limit
        del y, xr, xi, gr, gi
    emit({"unrolled_step_costs": out, "n_qubits": SV_QUBITS,
          "warp_launch_at_8q_main": {"warps_per_cta": warps, "smem_per_cta": smem,
                                     "grid": grid, "ctas_per_sm": ctas},
          "tile_step_costs": {str(b): rows}, "tile_qubits": n, "tile_rows_staging": staging,
          "tile_launch_at_10q_B425": cfg.__dict__, "card": nvidia_smi_line()})


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


def unrolled_check():
    """``--unrolled``: build unrolled_sv.cu, then the launch floor and the
    unrolled_shapes and unrolled_kernels phases alone (the quick check
    after a change to K3/K4)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    built = build_phase(["unrolled_sv"])
    floor = launch_floor_phase()
    gen = torch.Generator(device=dev).manual_seed(7)
    unrolled_phases(dev, gen, peaks(torch.cuda.get_device_name(0)), smi,
                    ptxas_registers(built["unrolled_sv"][2]), floor, main_paths=False)
    print(smi, flush=True)


SV_RATE_STEPS = 1000  # north_star_plain's timed steps in --sv-rates


def sv_rates(tree: str):
    """``--sv-rates TREE``: with TREE's ``qcpinn_tpu_torch``, the numbers
    that hold two trees' K3/K4 side by side: K3 and K4 (``unrolled_fwd``,
    ``unrolled_bwd_partials``) by graph at the 8q and 10q main paths'
    shapes, on inputs from a seed of their own; the sha256 of K4's outputs
    (``unrolled_bwd``, fed the random unit-norm state as its final state,
    so that no forward's rounding enters) at every SV_SHAPES shape of
    n <= 9 and at the 8q main shapes, so that two trees' warp route can be
    held bit-equal; the 8q bench step (graphed, 30 steps, then a 3-step
    profile: device ms a step); and the ``north_star --solver plain`` step
    at 10 qubits (its ``make_stage``, graphed: SV_RATE_STEPS timed steps,
    then a 3-step profile). One JSON line. To compare two trees, run it
    once per tree in one call, in turns (A, B, B, A)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(tree))
    import qcpinn_tpu_torch
    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.ops import cuda_build
    from qcpinn_tpu_torch.ops import sv_kernel as sk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    cuda_build.build_all(["unrolled_sv"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    kernels = {}
    for n_q, batches in ((SV_QUBITS, SV_BATCHES), (SV_TILE_QUBITS, SV_TILE_BATCHES)):
        circ = DVCircuit(n_q, 1, "cross_mesh", seed=42)
        for b, mode in batches:
            mp, _, _, banks, (xr, xi, gr, gi) = sv_inputs(sk, circ, b, mode, gen, dev)
            y = sk.unrolled_fwd(xr, xi, *banks, mp)
            row = {"fwd_graph_ms": graph_ms(lambda: sk.unrolled_fwd(xr, xi, *banks, mp)),
                   "bwd_graph_ms": graph_ms(
                       lambda: sk.unrolled_bwd_partials(*y, gr, gi, *banks, mp))}
            if n_q <= 9:
                row["bwd_sha256"] = digest(sk.unrolled_bwd(xr, xi, gr, gi, *banks, mp))
            kernels[f"{n_q}q_B{b}"] = row
            del y, xr, xi, gr, gi
            torch.cuda.empty_cache()
    shapes = {}
    for n, ansatz, layers, seed, enc, b in SV_SHAPES:
        if n > 9:
            continue
        circ = DVCircuit(n, layers, ansatz, encoding=enc, seed=seed)
        for mode in ("evolve",) if enc == "amplitude" else ("apply", "evolve"):
            mp, _, _, banks, (xr, xi, gr, gi) = sv_inputs(sk, circ, b, mode, gen, dev)
            shapes[f"{ansatz}_{enc}_n{n}_layers{layers}_B{b}_{mode}"] = digest(
                sk.unrolled_bwd(xr, xi, gr, gi, *banks, mp))
    trainer = bench.build(n_qubits=SV_QUBITS)
    ms = 1e3 * bench.run(trainer, steps=10)
    step8 = bench.profile(trainer, ms, steps=3, top=4)
    del trainer
    torch.cuda.empty_cache()
    args = ns.parse_args(["--solver", "plain", "--qubits", "10", "--backend", "unrolled",
                          "--total-steps", str(SV_RATE_STEPS + 29)])
    cfg, model, use_streams, backend = ns.build_model(args, dev)
    stage = ns.make_stage(model, cfg, args, ns.make_terms(args), "train", backend,
                          use_streams)
    stage.run(25)  # the warm-ups and the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = stage.run(SV_RATE_STEPS)["loss"]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SV_RATE_STEPS
    plain = bench.profile(type("Steps", (), {"step": lambda self: stage.run(1)})(), ms,
                          steps=3, top=4)
    emit({"tree": tree, "package": os.path.dirname(qcpinn_tpu_torch.__file__),
          "kernels": kernels, "bwd_sha256_by_shape": shapes, "bench_8q": step8,
          "north_star_plain": {**plain, "steps": SV_RATE_STEPS,
                               "losses_finite": bool(torch.isfinite(losses).all())},
          "card": nvidia_smi_line()})


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
    if sys.argv[1:] == ["--unrolled"]:
        return unrolled_check()
    if len(sys.argv) == 3 and sys.argv[1] == "--sv-rates":
        return sv_rates(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--rates":
        return rates(sys.argv[2])
    if sys.argv[1:] == ["--cli-train"]:
        return cli_train_check()
    if sys.argv[1:] == ["--hw-modes"]:
        return hw_modes_check()
    if sys.argv[1:] == ["--cz-phase"]:
        return cz_phase_check()
    if sys.argv[1:] == ["--cz"]:
        return cz_check()
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

    # -- 6d-6e. the README's entry point (no kernel on this path) ------------
    cli_train_phase(dev, smi)
    torch.cuda.empty_cache()
    north_star_classical_phase(dev, smi)
    torch.cuda.empty_cache()

    # -- 6f. the hardware-fidelity modes --------------------------------------
    hw_launches = {k.rsplit(".", 1)[1]: v for k, v in hw_modes_phase(dev, smi).items()}
    torch.cuda.empty_cache()

    # -- 6g. the Czochralski flagship (no kernel on this path) ---------------
    cz_phase(dev, smi)
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
    for row in kernels:  # the launches of the hw_modes phase's engine checks
        row["hw_modes_launches"] = hw_launches.get(row["name"], 0)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
