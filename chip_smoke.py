#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (qcpinn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. device      the card, nvidia-smi's name and power limit, versions, TF32 off.
2. build       nvcc builds ops/csrc/block_chain.cu and ops/csrc/gate_loop.cu
               from the checkout, one process per source, started together.
3. kernel_shapes the other sizes ``auto`` sends to the block-chain kernels
               (n = 10, 11, 12 with 3 layers; B = 37 and B = 1), and uneven
               block splits (a 128-wide block: the backward's matrix
               cotangent then has more 4x4 tiles than the CTA has threads)
               against the plain versions, same limits as below.
4. kernels     every block-chain kernel at the 12q main path's shapes
               (B = 6144 stream rows and B = 682 value rows) against its
               plain PyTorch version on the same inputs: forward <= 2e-5
               (unit-norm states), backward <= 2e-4 * max|ref| per output,
               reduction <= 1e-6 * max|ref|. Times from CUDA events (median).
5. step_parity one 12-qubit train step through the kernels against the same
               step on the plain block engine: same params, same points; loss
               rtol 2e-5, every grad atol 2e-4 * max(|ref|, 1e-3).
6. train       the 12q main path: the bench train step (B = 1024, hidden 50,
               lr 5e-3, seed 42) for 30 steps with the launch counters set to
               0 just before: every loss finite, each block-chain kernel
               launched exactly twice a step, no plain version called.
7. loop_shapes the gate-loop kernels (K5/K6) against their plain versions at
               cross_mesh n = 10, 12, 16, cascade n = 10 (controlled gates),
               12q with 3 layers, B = 37 and B = 1: forward <= 5e-6 absolute
               on unit-norm states, backward <= 2e-4 * max|ref| per output,
               and the backward bit-equal across two runs.
8. loop_kernels K5, K6 and their slab reduction at the 16q main path's shapes
               (B = 1536 stream rows, B = 425 value rows), same limits, with
               times beside the plain versions and the plain block engine.
9. step_parity_16q one north-star stage-2 step at 16 qubits through the loop
               kernels against the same step on the plain block engine (RBF
               head, same weights and points); limits as in 5.
10. north_star the 16q main path: ``north_star.run`` at full width (16
               qubits, B = 256, hidden 64, 8 RBF units) with --backend loop,
               stage 1 its minimum chunk (500 steps), stage 2 50 steps, then
               the rel-L2 evaluation on the 20^3 grid by streams, with the
               launch counters set to 0 just before: every loss finite, K5
               and K6 launched exactly twice per stage-2 step (K5 twice more
               per evaluation chunk), no plain version called. Then the
               stage-2 step rate on the loop and block engines, and a
               torch.profiler window of each.

Then the kernel summary line, the nvidia-smi line, and the result line.
"""

import json
import math
import os
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

# dense FP32 (non-tensor) rate and memory rate from NVIDIA's data sheets
PEAKS = {
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60.0e12, 3.9e12),
    "H200": (67.0e12, 4.8e12),
    "H100": (67.0e12, 3.35e12),  # SXM
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def peaks(name: str):
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


def bound(flops, nbytes, card_peaks):
    t_ops = flops / card_peaks[0] * 1e3
    t_bytes = nbytes / card_peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


LOOP_FWD_TOL = 5e-6
LOOP_SHAPES = (  # (n, ansatz, layers, B)
    (10, "cross_mesh", 1, 37), (12, "cross_mesh", 1, 37), (16, "cross_mesh", 1, 37),
    (10, "cascade", 1, 37), (12, "cross_mesh", 3, 37), (16, "cross_mesh", 1, 1),
    (12, "cross_mesh", 1, 1),
)
# the 16q main path's evolves: 6 x 256 stream rows and 5 x 85 value rows
LOOP_BATCHES = (6 * 256, 5 * (256 // 3))
# the north-star twin bounded by steps: stage 1 its one 500-step chunk,
# stage 2 a 25-step warm-up chunk and one timed chunk of 25
NORTH_STAR_ARGS = ["--backend", "loop", "--stage1-minutes", "1e-9",
                   "--stage1-steps", "500", "--chunk", "25", "--total-steps", "50",
                   "--minutes", "30"]
RATE_STEPS = 10


def loop_work(lk, lp, b):
    """(forward, backward) flops the gate table needs for B samples: per
    amplitude a mat step is 2 complex multiply-adds (8 flops each), a diag
    step 1 complex multiply (6), a u2q step 4 complex multiply-adds; a
    controlled mat touches half the amplitudes. The backward recovers the
    input and pulls the cotangent back (twice the forward) and accumulates
    the matrix (2 complex multiply-adds) or phase (8 flops) cotangents."""
    d = 1 << lp.n
    fwd = bwd = 0
    for st in lk.steps(lp):
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


class Stage2Stepper:
    """North-star stage-2 steps (streams residual, fused value walls, clip +
    cosine Adam at lr/5) of a model on one engine, for parity and timing."""

    def __init__(self, args, backend, dev, state_dict=None, terms=None,
                 optimizer=None):
        import zlib

        import torch

        from qcpinn_tpu_torch import north_star as ns
        from qcpinn_tpu_torch.physics.operators_fwd import diffusion_operator_fwd
        from qcpinn_tpu_torch.physics.streams import dv_diffusion_residual_streams
        from qcpinn_tpu_torch.train import optim as topt
        from qcpinn_tpu_torch.train.loop import make_train_step

        cfg, model, _, _ = ns.build_model(args, dev)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        ns.set_engine(model, args, backend)
        self.model = model
        opt = optimizer or topt.make_optimizer(args.lr / 5.0, grad_clip=1.0,
                                               schedule="cosine", epochs=args.total_steps)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.state = opt.init(self.params)
        self.sched = topt.plateau_init(dev)
        self.step_fn, _ = make_train_step(
            model, diffusion_operator_fwd, terms or ns.make_terms(args), opt, cfg,
            residual_fn=lambda X: dv_diffusion_residual_streams(model, X),
            fuse_value_terms=True,
        )
        self.gen = torch.Generator(device=dev).manual_seed(zlib.crc32(b"stage2"))

    def step(self):
        self.state, self.sched, m = self.step_fn(self.params, self.state, self.sched,
                                                 self.gen)
        return m["loss"]


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


def loop_phases(dev, gen, card_peaks, smi):
    """Phases 7-10; returns the K5/K6/reduction rows of the summary line."""
    import torch

    from qcpinn_tpu_torch import bench, north_star as ns
    from qcpinn_tpu_torch.ops import loop_kernel as lk
    from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
    from qcpinn_tpu_torch.ops.circuit import DVCircuit
    from qcpinn_tpu_torch.train import optim as topt
    from qcpinn_tpu_torch.train.loop import TermSpec

    # -- 7. loop_shapes ------------------------------------------------------
    shape_errs = {}
    for n, ansatz, layers, b in LOOP_SHAPES:
        circ = DVCircuit(n, layers, ansatz, seed=42)
        lp, _, banks, states = loop_inputs(lk, circ, b, gen, dev)
        tag = f"{ansatz}_n{n}_layers{layers}_B{b}"
        shape_errs[tag], _, _ = check_loop(lk, lp, banks, states, tag)
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
        xr, xi, gr, gi = states
        bank_bytes = 4 * sum(t.numel() for t in banks)
        f_ops, b_ops = loop_work(lk, lp, b)
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
                "bound_ms": fb, "bound_by": fby,
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
            "bound_ms": bb, "bound_by": bby, "grid": partials.shape[0],
        }
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
        st = Stage2Stepper(args, backend, dev, state_dict=sd, terms=fixed,
                           optimizer=opt)
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
    eval_chunks = -(-20**3 // min(512, 8 * args.batch))
    want = {"gate_loop_fwd": 2 * s2 + 2 * eval_chunks, "gate_loop_bwd": 2 * s2,
            "gate_loop_reduce": 2 * s2}
    for k, v in want.items():
        if launches[k] != v:
            raise SystemExit(f"north_star: {k} launched {launches[k]} times, want {v}")
    for k in ("gate_loop_fwd_ref", "gate_loop_bwd_ref", "gate_loop_reduce_ref"):
        if launches[k] != 0:
            raise SystemExit(f"north_star: plain version {k} ran {launches[k]} times")
    if s2 < 20 or result["backend"] != "LoopFusedCircuit":
        raise SystemExit(f"north_star: stage 2 ran {s2} steps on {result['backend']}")
    # the stage-2 step rate on each engine, same weights, one process
    rates = {}
    profiles = {}
    for backend in ("loop", "block"):
        st = Stage2Stepper(args, backend, dev)
        for _ in range(3):
            st.step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RATE_STEPS):
            loss = st.step()
        float(loss)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / RATE_STEPS
        rates[backend] = {"ms_per_step": 1e3 * dt, "points_per_sec": args.batch / dt}
        profiles[backend] = bench.profile(st, steps=3, top=8)
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
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    return rows


def main():
    import torch

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
    built = cuda_build.build_all(["block_chain", "gate_loop"])
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
        got = bk.block_chain_bwd(*got, gr.contiguous(), gi.contiguous(), mct, ph, eng.plan)
        want = bk.block_chain_bwd_ref(*want, gr, gi, mct, ph, eng.plan)
        e_bwd = max((a - r).abs().max().item() / r.abs().max().item()
                    for a, r in zip(got, want))
        tag = f"n{n}_hb{eng.plan.hb}_layers{layers}_B{b}"
        if not (e_fwd <= FWD_TOL and e_bwd <= BWD_RTOL):
            raise SystemExit(f"{tag}: fwd {e_fwd} bwd {e_bwd}")
        shape_errs[tag] = {"fwd_abs": e_fwd, "bwd_rel": e_bwd}
    emit({"phase": "kernel_shapes", "results": shape_errs})

    # -- 4. kernels vs plain versions at the main path's shapes ------------
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
        if not torch.equal(gxr, got[0]):
            raise SystemExit("block_chain_bwd is not deterministic")
        slab = partials.shape[1]
        bb, bby = bound(3 * b * mat_flops + 20 * b * h * l * plan.n_diags,
                        6 * state_bytes + mats_bytes + ph_bytes + 4 * slab,
                        card_peaks)
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
            "bound_ms": bb, "bound_by": bby, "grid": partials.shape[0],
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
    kern = bench.build(backend="block_kernel")
    plain = bench.build(backend="block")
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
        raise SystemExit(f"step loss {losses}")
    worst = {}
    for k, ref in grads["plain"].items():
        scale = max(ref.abs().max().item(), 1e-3)
        e = (grads["kernel"][k] - ref).abs().max().item()
        if not e <= 2e-4 * scale:
            raise SystemExit(f"step grad {k}: {e} > 2e-4 * {scale}")
        worst[k] = e / scale
    emit({"phase": "step_parity", "loss_kernel": losses["kernel"],
          "loss_plain": losses["plain"],
          "max_grad_err_over_scale": max(worst.values())})
    del kern, plain, grads

    # -- 6. the main path: the bench train step ----------------------------
    trainer = bench.build()
    if not isinstance(trainer.model._fused, bk.BlockKernelCircuit):
        raise SystemExit(f"auto picked {type(trainer.model._fused).__name__}")
    for _ in range(3):
        trainer.step()
    torch.cuda.synchronize()
    bk.reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.step() for _ in range(STEPS)]
    losses = torch.stack(losses).tolist()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    for k in ("block_chain_fwd", "block_chain_bwd", "block_chain_reduce"):
        if launches[k] != 2 * STEPS:
            raise SystemExit(f"{k}: {launches[k]} launches in {STEPS} steps")
    for k in ("block_chain_fwd_ref", "block_chain_bwd_ref", "block_chain_reduce_ref"):
        if launches[k] != 0:
            raise SystemExit(f"plain version {k} ran {launches[k]} times")
    emit({"phase": "train", "steps": STEPS, "batch": trainer.batch,
          "points_per_sec": trainer.batch * STEPS / dt, "ms_per_step": 1e3 * dt / STEPS,
          "loss_first": losses[0], "loss_last": losses[-1],
          "launches": launches, "card": smi})

    del trainer
    torch.cuda.empty_cache()

    # -- 7-10. the 16q north-star path through the gate-loop kernels ---------
    loop_results = loop_phases(dev, gen, card_peaks, smi)

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
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    kernels += loop_results
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
